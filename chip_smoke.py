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
     leaks, tokens equal the serial oracle;
  12. serve full-width, full-depth xlstm-350m (ssm: 3 x (7 mLSTM + 1
     sLSTM) blocks, no attention) in bf16 through the serial path, 4
     instances, 6 requests of 512-2048 prompt tokens, 16 new tokens each:
     no kernel launches at all, the recurrent state on the card in
     ``engine._real_cache``; spans for serial prefill (the sLSTM scan on
     its own), decode and ``max_memory_allocated``;
  13. ssm / audio parity: xlstm-350m width, one superblock, f32 — the
     engine's greedy tokens equal the model's greedy prefill + decode loop,
     and prefill + one decode equals ``forward`` (also for full-width,
     full-depth whisper-tiny, f32) within 3e-3 x (max|logit| + 1); then
     whisper-tiny in bf16 at its real shapes (4 x 1500 encoder frames, a
     448-token decoder prompt, 32 greedy decode steps over a padded cache):
     K4 and K5 launched, K1-K3 not, every step's logits within
     3e-2 x (max|logit| + 1) of the same run through the plain attention;
  14. the serve CLI in process: ``repro_torch.launch.serve.main(["--real",
     ...])`` (reduced lwm-7b, f32, on the card) finishes every request with
     zero migration and tokens equal to the serial oracle on the engine the
     CLI built, then every ``--system`` in sim mode; its K1-K3 launches are
     listed under ``launches_by_path`` and not added to the rows' totals;
  15. the mesh executor on NCCL at world size 1 (one card: NCCL takes one
     rank per device): open the group, hold `paged_decode_spmd` (overlap on
     and off) at phase 4's decode batch and lwm-7b width, the batch-sharded
     `paged_decode_iteration_spmd` (full width, 2 layers, f32: ids equal the
     plain decode's argmax, routed KV within 1e-4) and
     `ring_packed_prefill_spmd` at n == 1 (K1, bf16) against their plain
     versions; print the collectives' dispatches and bytes; then serve
     lwm-7b (full width, 16 of 32 layers, bf16, phase 4's requests) and the
     f32 2-layer parity run through ``executor="mesh"`` (one data
     coordinate: every instance aliases and the executor replays in
     process) with tokens equal to the serial oracle; K1-K3 launched;
  16. training through ``repro_torch.launch.steps.make_train_step``: (a)
     full-width lwm-7b cut to 4 of its 32 layers, bf16 params, f32
     moments, B 2 x S 4096, loss_chunk 1024, remat, lr 3e-4, 8 steps on
     one fixed batch: the loss at step 8 is below step 1, K4's forward
     launches 2 x 4 x 8 times (remat recomputes it) and its backward 4 x 8,
     K1, K2, K3 and K5 never; the wall per step, tokens/s, the forward /
     backward (the K4 backward's share from CUDA events) / optimizer split
     and ``max_memory_allocated``; (b) gradient parity at lwm-7b width, 2
     layers, f32, B 1 x S 2048: one step through the kernels against the
     same step through the plain attention — loss within 1e-5 relative,
     every leaf of the new m within 1e-4 x max|leaf|, new params within
     1e-6 beyond lr x the difference of the two AdamW directions;
  17. the mesh-aware steps (`launch.steps` on a `DeviceMesh`: DTensor
     parameters, inputs and ZeRO-1 moments, `ESPAttnImpl` /
     `ShardedAttnImpl` through `local_map`) on NCCL at world size 1, mesh
     (1, 1), after importing `local_map` and `DTensor`, at full width in
     bf16 (`MESH_SERVE`, `MESH_TRAIN`): lwm-7b cut to 4 of its 32 layers
     (prefill B 1 x S 8192, 16 decode steps, 2 train steps at B 2 x S
     4096), zamba2-2.7b cut to 2 of its 9 superblocks (prefill B 1 x S
     4096, 8 decode steps), mixtral-8x7b cut to 2 of its 32 layers
     (prefill B 1 x S 8192 under its 4096-token window, 8 decode steps, 2
     train steps of one layer at B 1 x S 4096; layer 0's `apply_moe` drops
     the same fraction on the mesh at capacity factor 1.25 and 0.5),
     pixtral-12b cut to 4 of its 40 layers (1024 image embeddings + 3072
     text tokens, 8 decode steps) and whisper-tiny at full depth (B 4 x
     1500 frames, a 448-token prompt, 16 decode steps, 2 train steps):
     tokens equal the ``mesh=None`` steps', caches, parameters and losses
     within bf16 tolerances, K4 (forward and backward) and K5 launched,
     K1-K3 not;
  18. the op census (`launch.census`, the dry run's count of a step's
     work) around phase 16 / 17's lwm-7b steps on the card (full width, 4
     of 32 layers, bf16, ``mesh=None``): a prefill of B 1 x S 8192, 16
     decode steps and a train step of B 2 x S 4096 with remat; K4, its
     backward and K5 launch, the census counts one kernel call per launch,
     and the same steps built on meta tensors give identical FLOPs, bytes
     and kernel work.  Each step's roofline terms (census FLOPs over 989e12
     FLOP/s, bytes over 3.35e12 B/s) beside its measured time (CUDA
     events, median of 5), the share max(compute, memory) / measured
     (above 1.05 fails) and `model_flops_estimate` / (measured x 989e12);
     then examples/torch_quickstart.py and
     examples/torch_elastic_scaling_demo.py run on the card as
     subprocesses (exit 0, kernels launched, tokens equal to the oracle).

Phases 2-3 also hold `ops.attention_partial` (K4 with its row LSE as the
ESP ring step's unnormalized partial, its o in f32) against the plain
partial at a 4-rank ring step of lwm-7b width (S_local 4096, striped
positions, rows that see no key), of mixtral width with its 4096-token
window and of pixtral width, and at whisper width on one rank, and K5
at a decode mode-2 shard (lwm-7b width, B 8, a 4096-key shard at
k_pos_offset 12288, with and without a window), timed beside their bounds,
their plain versions and the one PyTorch call of the same function (the
``at_esp_ring_step`` / ``at_esp_decode_shard`` fields of the K4 / K5
rows).  They also hold the K4 backward (csrc/striped_attention_bwd.cu) and
the forward's row LSE against the plain backward formula and the plain
LSE at lwm-7b (B 2, S 4096, causal, bf16 and f32), mixtral (S 6144, window
4096, GQA 4), glm4 (GQA 16, S 2048), zamba2 (D 80), whisper (D 64, B 4)
and the train CLI's reduced width (D 32, f32), plus softcap, non-causal,
striped, unsorted and empty-row variants (f32 within 2e-4 x max|plain|;
bf16 within 2^-7 x max|plain|, mean within 1e-3 x max|plain|; LSE within
1e-4; empty rows exact zeros; every bf16 case twice, bitwise equal), and
time it at lwm-7b and mixtral width beside its plain version, its bound
and SDPA's backward (the "K4 bwd" row), with SDPA's own error against the
plain formula under the same measure printed as a witness of bf16
rounding.  Its bf16 route runs on wgmma: the phase prints the backward's
``-Xptxas -v`` lines and HGMMA counts from ``cuobjdump -sass``, and fails
if a tensor-core kernel of it has no HGMMA, spills or is serialized by
ptxas (info C7513), or an f32 one has HGMMA.  They also hold K4 and K5 at whisper-tiny's width (H = KVH = 6, D =
64, q_per_kv 1; K4: B = 4, causal, S 448 and 1500, bf16 and f32; K5: B =
4 over 480 keys, 479 valid in every row and ragged rows), timed as device
time from CUDA graphs, beside SDPA ``is_causal`` and the flash call
(``at_whisper_width`` fields of the K4 / K5 rows), and K2 and K3 at the
unified step's shapes (K2: B = 512
per-token rows over tables 4096 wide, a third of them empty; K3: n_shards
= 1, four chunks, 32 one-row segments and padding, carried from K2's
output) and add their times and both K2 bounds (distinct bytes, bytes as
launched) to the K2 / K3 rows as ``unified_*`` fields.  Phase 2 also holds
K1, K3 (rings of 2, 4 and 8 shards) and K2 at phase 14's shapes (reduced
lwm-7b: f32, H = KVH = 4, D = 32, page size 1, the CLI's own prompts).

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of this repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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
           "K2": 2.541, "K5": 0.8049, "K5 zamba2": 1.536,
           "K4 bwd lwm-7b B=2 S=4096": 78.63, "K4 bwd mixtral S=6144 window=4096": 77.86}
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


def _ptxas_kernels(report):
    """{kernel: (registers line, spill line)} of one ``-Xptxas -v`` report,
    and its lines that say ptxas serialized wgmmas (info C7513)."""
    kernels, serialized, entry, spill = {}, [], None, ""
    for line in report.splitlines():
        if "C7513" in line:
            serialized.append(line.strip())
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spill = line.split(":")[-1].strip()
        elif "Used" in line and entry:
            kernels[_short_kernel_name(entry)] = (line.split(":")[-1].strip(), spill)
            entry = None
    return kernels, serialized


def _sass_counts(lib, opcode):
    """{kernel: number of `opcode` instructions} in a built library's SASS
    (``cuobjdump -sass``); None where cuobjdump is missing."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return None
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = _short_kernel_name(line.split("Function :")[1].strip())
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} kernel libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():  # one line per kernel: registers, spills
        kernels, serialized = _ptxas_kernels(rep)
        for kern, (used, spill) in kernels.items():
            print(f"[ptxas {name}] {kern}: {used}; {spill}")
        for line in serialized:
            print(f"[ptxas {name}] {line}")


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
    _check_cli_shapes(log, randn, rng)
    print("\n".join(log))
    torch.cuda.empty_cache()


def _check_cli_shapes(log, randn, rng):
    """K1, K3 and K2 at the shapes phase 14's ``serve --real`` gives them:
    reduced lwm-7b (f32, H = KVH = 4, D = 32, page size 1), the CLI's own
    sharegpt prompts as one packed batch, K3 through full rings of 2, 4 and
    8 shards (each step against the plain step on the same carry, then the
    finalized ring against plain K1), K2 over those prompts' decode
    contexts."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import striped
    from repro_torch.data import poisson_workload
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import paged_flash_prefill as pfp

    cfg = reduced(get_config("lwm-7b"))
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    f32 = torch.float32
    lens = [r.input_len for r in poisson_workload("sharegpt", 8, 0.5, seed=0,
                                                   max_len=256)]
    tag = f"serve CLI shapes (H = {H}, KVH = {KVH}, D = {D}, f32, prompts {lens})"
    T = -(-sum(lens) // 64) * 64  # bucket padding: its own segment
    off = _offsets(lens, len(lens) + 1)
    q, k, v = randn(T, H, D, dtype=f32), randn(T, KVH, D, dtype=f32), randn(T, KVH, D, dtype=f32)
    k1 = pfp.packed_flash_prefill_plain(q, k, v, off)
    _check(f"K1 {tag}", pfp.packed_flash_prefill(q, k, v, off), k1, log)
    for n in (2, 4, 8):
        offs = [striped.shard_offsets(off, n, r) for r in range(n)]
        sched = striped.ring_chunk_schedule(n)
        kc, pc, steps = [None] * n, [None] * n, []
        for step in range(n):
            for r in range(n):
                c = sched[step][r]
                args = (q[r::n].contiguous(), k[c::n].contiguous(),
                        v[c::n].contiguous(), offs[r], offs[c])
                kw = dict(q_shard=r, k_shard=c, n_shards=n)
                kc[r] = pfp.packed_flash_prefill_ring_chunk(*args, pc[r], **kw)
                pc[r] = pfp.packed_flash_prefill_ring_chunk_plain(*args, pc[r], **kw)
                # one summary line per ring: a failing step prints its own
                steps.append(_check(f"K3 n={n} step={step} shard={r} {tag}",
                                    kc[r], pc[r], log[:1]))
        ring = striped.unstripe(torch.cat([_fin(o, l) for o, _, l in kc]), n, axis=0)
        _check(f"K3 ring n={n} {tag}: finalized vs plain K1", ring, k1, log)
        log[-1] += f"; {len(steps)} steps, max step err {max(steps):.3e}"
    ctx = np.asarray(lens, np.int32) + 15  # the CLI's 16 new tokens
    b, n_slots = len(lens), int(ctx.sum()) + 8
    kp, vp = randn(n_slots, 1, KVH, D, dtype=f32), randn(n_slots, 1, KVH, D, dtype=f32)
    perm = rng.permutation(n_slots)
    table = np.zeros((b, int(ctx.max())), np.int32)
    c0 = 0
    for i in range(b):
        table[i, :ctx[i]] = perm[c0:c0 + ctx[i]]
        c0 += ctx[i]
    a = (randn(b, 1, H, D, dtype=f32), kp, vp, torch.as_tensor(table, device=q.device),
         torch.as_tensor(ctx, device=q.device))
    _check(f"K2 page=1 {tag}", pfd.paged_flash_decode_partial(*a),
           pfd.paged_flash_decode_partial_plain(*a), log)


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
    attention of each GQA group's q rows over the rows' valid keys (the
    same range in every row) returns
    (output, logsumexp), which is the partial (o = output, m = logsumexp,
    l = 1).  Held once against the plain partial, both finalized.  Returns
    (ms, how it was timed, the call's name)."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    b, _, h, d = q.shape
    kvh = kvs[0][0].shape[2]
    assert len(set(ln.tolist())) == 1, "one valid key range for every row"
    n = int(ln[0])  # the rows' valid keys [lo, hi) in shard coordinates
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
    # ---- K4 at whisper width: whisper-tiny's decoder self-attention
    # prefill (H = KVH = 6, D = 64, causal, no window), B = 4 as in phase
    # 13; launches this small take microseconds, so device time from CUDA
    # graphs, for the kernel and for SDPA alike
    whisper = {}
    for s_ in (448, 1500):
        b, h, d = 4, 6, 64
        q, k, v = randn(b, s_, h, d), randn(b, s_, h, d), randn(b, s_, h, d)
        pos = ipos(ar(s_))
        kw = dict(causal=True, window=None, softcap=None)
        tag = f"whisper B=4 S={s_}"
        k4_err = max(k4_err, _check(
            f"K4 {tag}", sa.striped_flash_attention(q, k, v, pos, pos, **kw),
            sa.striped_flash_attention_plain(q, k, v, pos, pos, **kw), log, v=v))
        qf, kf, vf = q.float(), k.float(), v.float()
        _check(f"K4 {tag} f32", sa.striped_flash_attention(qf, kf, vf, pos, pos, **kw),
               sa.striped_flash_attention_plain(qf, kf, vf, pos, pos, **kw), log)
        f32_ms, _ = _device_ms(lambda i: sa.striped_flash_attention(qf, kf, vf, pos, pos,
                                                                    **kw))
        del qf, kf, vf
        pairs = b * s_ * (s_ + 1) // 2
        flops = 4 * h * d * pairs
        bytes_ = 4 * b * s_ * h * d * q.element_size()  # q, k, v read, o written
        ms, how = _device_ms(lambda i: sa.striped_flash_attention(q, k, v, pos, pos, **kw))
        plain_ms = _time_ms(lambda: sa.striped_flash_attention_plain(
            q, k, v, pos, pos, **kw), 3, 1)
        q4, k4, v4 = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms, _ = _device_ms(lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
        bound = max(flops / PEAK_BF16, bytes_ / HBM_BPS) * 1e3
        by = "operations" if flops / PEAK_BF16 > bytes_ / HBM_BPS else "bytes"
        whisper[f"B4_S{s_}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                    bound_by=by, library_ms=lib_ms)
        print(f"[time {card}] K4 {tag}: kernel {ms:.4f} ms ({how}), "
              f"{_rates(flops, ms, bound)}, plain {plain_ms:.3f} ms, sdpa "
              f"{lib_ms:.4f} ms ({how}), f32 route {f32_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by}; {flops / 1e9:.2f} GFLOP, {bytes_ / 1e6:.2f} MB)")
        del q4, k4, v4
    rec["K4"] = dict(
        name="striped_flash_attention", route="cuda",
        source="src/repro_torch/csrc/striped_attention.cu",
        replaces="src/repro/kernels/striped_attention.py:102",
        max_abs_err=k4_err, **timed["mixtral S=6144 window=4096"],
        at_whisper_width=whisper)

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
        # whisper-tiny's decode history (H = KVH = 6, D = 64): phase 13's
        # last step (B = 4, 479 cached keys each), then ragged rows
        ("whisper B=4 ctx=479", 4, 480, [479] * 4, 0, 6, 6, 64, bf16, bf16,
         None, None),
        ("whisper B=4 ragged", 4, 480, [0, 200, 448, 479], 0, 6, 6, 64, bf16,
         bf16, None, None),
    ]
    untimed = ("mixtral B=1 ctx=8192", "whisper B=4 ragged")
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
        if tag.startswith(untimed):
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
        if len(set(lens)) == 1:  # the serial paths' shapes: one flash call
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
        if tag.startswith("whisper"):
            rec["K5"]["at_whisper_width"] = {"B4_ctx479": dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)}
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
           serial=False, **engine_kw):
    """One real-mode engine run, built as the serve CLI builds it; returns
    (metrics, kernel launches, dispatch counts, wall seconds, {stage:
    seconds} spans).  ``serial`` families (moe, hybrid, ssm) take the
    per-request path: K4 and K5 must launch and K1-K3 not (no kernel at all
    for the attention-free ssm family); otherwise the packed / paged path:
    K1-K3 must launch and no serial prefill run."""
    import torch

    from repro_torch.convert import init_params
    from repro_torch.engine.request import Request
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    eng = build_engine("loongserve", cfg, n_inst, capacity, store_values=True,
                       model=model, params=params, **engine_kw)
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
    serial_attn = ("striped_flash_attention", "flash_decode_partial")
    if serial and cfg.n_attention_applications:
        _expect_launches(counts, serial_attn, packed)
    elif serial:  # attention-free (xLSTM): no kernel at all
        _expect_launches(counts, (), packed + serial_attn)
    if serial:
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


def phase_xlstm_serve(card):
    """Phase 12: full-width, full-depth xlstm-350m (ssm: 21 mLSTM + 3 sLSTM
    blocks, no attention) in bf16 through the serial path; the sLSTM scan
    (a Python loop over the prompt's tokens) is timed on its own."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import param_shapes
    from repro_torch.models import xlstm
    from repro_torch.models.transformer import xlstm_layout

    cfg = get_config("xlstm-350m")
    n_super, m_per = xlstm_layout(cfg)
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model)
    dh = d_in // cfg.n_heads
    state_mb = n_super * m_per * cfg.n_heads * (dh * dh + dh + 1) * 4 / 1e6

    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(v) for v in tree.values())
        return int(np.prod(tree[0]))

    n_params = numel(param_shapes(cfg))
    print(f"[serve] xlstm-350m: {n_params / 1e9:.3f} B parameters "
          f"({n_params * 2 / 1e9:.2f} GB in bf16; the config's estimate "
          f"{cfg.param_count() / 1e9:.3f} B), {n_super} x ({m_per} mLSTM + 1 "
          f"sLSTM) blocks, mLSTM state {state_mb:.1f} MB per request (f32)")
    scan_spans = {}
    scan = xlstm.slstm_scan

    def timed_scan(p, xm, cfg_, state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return scan(p, xm, cfg_, state)
        finally:
            torch.cuda.synchronize()
            key = "sLSTM scan (prefill)" if xm.shape[1] > 1 else "sLSTM step (decode)"
            scan_spans[key] = scan_spans.get(key, 0.0) + time.perf_counter() - t

    lens = [int(x) for x in np.random.default_rng(12).integers(512, 2049, 6)]
    xlstm.slstm_scan = timed_scan
    try:
        m, counts, dispatch, wall, spans = _serve(cfg, 4, 4096, lens, 16, 12,
                                                  False, serial=True)
    finally:
        xlstm.slstm_scan = scan
    _report("xlstm-350m full depth bf16", cfg, m, counts, dispatch, wall,
            {**spans, **scan_spans}, lens, 16)
    host = (spans.get("decode: host gather of the KV", 0.0)
            + spans.get("host->device uploads (KV, tokens)", 0.0))
    print(f"[serve] xlstm-350m: wall split: serial prefill {spans.get('prefill', 0.0):.3f} s "
          f"(sLSTM scan {scan_spans.get('sLSTM scan (prefill)', 0.0):.3f} s of it), "
          f"decode {spans.get('decode', 0.0):.3f} s (host gather + upload "
          f"{host:.3f} s of it: the pool's one zero layer of an attention-free "
          f"model; sLSTM steps {scan_spans.get('sLSTM step (decode)', 0.0):.3f} s)")
    gc.collect()
    torch.cuda.empty_cache()


def _forward_vs_decode(cfg, seed, b, t, tag):
    """Logits of `prefill` + one `decode` over a padded cache against
    `forward` over the whole sequence, within tests/test_arch_smoke.py's
    3e-3 x (max|logit| + 1)."""
    import torch

    from repro_torch.convert import init_params
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t + 1)), device=dev)
    batch = {"tokens": toks[:, :t]}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed)) * 0.05
    full, _ = model.forward(params, dict(batch, tokens=toks))
    _, cache = model.prefill(params, batch)
    if cache.k is not None:
        pad = cache.k.new_zeros(cache.k.shape[:2] + (t + 4,) + cache.k.shape[3:])
        k_pad, v_pad = pad, pad.clone()
        k_pad[:, :, :t] = cache.k
        v_pad[:, :, :t] = cache.v
        cache = cache._replace(k=k_pad, v=v_pad)
    dec, _, _ = model.decode(params, toks[:, t], cache)
    scale = full[:, -1].abs().max().item() + 1.0
    err = (dec - full[:, -1]).abs().max().item()
    print(f"[parity] {tag}: prefill + decode vs forward: max abs err {err:.3e} "
          f"(tol 3e-3 x {scale:.3f} = {3e-3 * scale:.3e})")
    assert torch.isfinite(full).all() and err < 3e-3 * scale, (tag, err, scale)


def phase_ssm_audio_parity(card, rec):
    """Phase 13: xlstm token parity and forward-vs-decode logits (f32), then
    whisper-tiny in bf16 at its real shapes through K4 and K5."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.kernels.ref import PlainAttnImpl
    from repro_torch.models import build_model

    # ---- (a) xlstm-350m width, one superblock (7 mLSTM + 1 sLSTM), f32:
    # the engine's greedy tokens equal the model's own prefill + decode loop
    x13 = dataclasses.replace(get_config("xlstm-350m"), n_layers=8, dtype="float32")
    lens = [129, 300, 777, 1024]  # chunk = min(256, T): below, across, a multiple
    _, counts, _, wall, _ = _serve(x13, 4, 4096, lens, 6, 13, True, serial=True)
    print(f"[parity] xlstm-350m width, 1 superblock, f32: {len(lens)} requests "
          f"(prompts {lens}) token-identical to the greedy prefill + decode "
          f"loop; launches {counts}; wall {wall:.3f} s")
    # ---- (b) prefill + decode against forward: xlstm (as above) and
    # full-width, full-depth whisper-tiny, f32
    _forward_vs_decode(x13, 13, 2, 300, "xlstm-350m width, 1 superblock, f32")
    wh = get_config("whisper-tiny")
    _forward_vs_decode(dataclasses.replace(wh, dtype="float32"), 14, 2, 64,
                       "whisper-tiny full width and depth, f32")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) whisper-tiny in bf16 at its real shapes: 4 x 1500 encoder
    # frames, a 448-token decoder prompt, 32 greedy decode steps over a
    # padded cache; K4 runs the decoder's self-attention prefill, K5 its
    # decode history
    dev = torch.device("cuda")
    model = build_model(wh)
    params = init_params(wh, torch.Generator(device=dev).manual_seed(15))
    gen = torch.Generator(device=dev).manual_seed(15)
    b, t, steps = 4, 448, 32
    frames = torch.randn((b, wh.encoder_seq, wh.d_model), device=dev,
                         generator=gen) * 0.05
    prompt = torch.randint(0, wh.vocab_size, (b, t), device=dev, generator=gen)

    def run(impl, forced=None):
        """Prefill + `steps` greedy decode steps (or the `forced` tokens);
        returns (tokens [B, steps + 1], logits of every step)."""
        prev = model.attn_impl
        if impl is not None:
            model.attn_impl = impl
        try:
            logits, cache = model.prefill(params, {"frames": frames, "tokens": prompt},
                                          last_logit_only=True)
            rows = [logits[:, 0]]
            pad = cache.k.new_zeros(cache.k.shape[:2] + (t + steps,) + cache.k.shape[3:])
            k_pad, v_pad = pad, pad.clone()
            k_pad[:, :, :t] = cache.k
            v_pad[:, :, :t] = cache.v
            cache = cache._replace(k=k_pad, v=v_pad)
            out = [rows[0].argmax(-1)]
            for i in range(steps):
                tok = out[-1] if forced is None else forced[:, i]
                logits, cache, kvs = model.decode(params, tok, cache)
                cache.k[:, :, t + i:t + i + 1] = kvs[0]
                cache.v[:, :, t + i:t + i + 1] = kvs[1]
                rows.append(logits)
                out.append(logits.argmax(-1))
            torch.cuda.synchronize()
            return torch.stack(out, 1), torch.stack(rows, 1)
        finally:
            model.attn_impl = prev

    _reset_counts()  # counts of this run only, from here
    t0 = time.perf_counter()
    toks, logits = run(None)
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    _expect_launches(counts, ("striped_flash_attention", "flash_decode_partial"),
                     ("packed_flash_prefill", "packed_flash_prefill_ring_chunk",
                      "paged_flash_decode_partial"))
    assert torch.isfinite(logits).all() and logits.shape == (b, steps + 1, wh.vocab_size)
    assert toks.shape == (b, steps + 1)
    # the same tokens through the plain attention: every step's logits agree
    # within 3e-2 x (max|logit| + 1) — bf16 activations, and K4's bf16
    # output may sit one bf16 step (2^-8 relative) from the plain one in
    # each of the 4 layers
    _, plain = run(PlainAttnImpl(), forced=toks[:, :steps])
    scale = plain.abs().max().item() + 1.0
    err = (logits - plain).abs().max().item()
    print(f"[parity] whisper-tiny bf16, {b} x {wh.encoder_seq} frames, {t}-token "
          f"prompt, {steps} decode steps: wall {wall:.3f} s; launches {counts}; "
          f"logits vs the plain attention max abs err {err:.3e} (tol 3e-2 x "
          f"{scale:.3f} = {3e-2 * scale:.3e})")
    assert err < 3e-2 * scale, (err, scale)
    for key, name in (("K4", "striped_flash_attention"), ("K5", "flash_decode_partial")):
        rec[key]["launches_by_path"]["whisper bf16 (phase 13)"] = counts.get(name, 0)
        rec[key]["launches"] += counts.get(name, 0)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_cli(card, rec):
    """Phase 14: ``python -m repro_torch.launch.serve`` in process: real mode
    on the card (reduced lwm-7b, f32), whose every request's tokens must
    equal the port's plain serial oracle on the engine the CLI built, then
    every system in sim mode."""
    import contextlib
    import io

    from repro_torch.launch import serve

    def cli(*args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(list(args))
        out = buf.getvalue()
        assert rc == 0, (args, rc)
        return json.loads(out[out.index("{"):])

    built = []
    build = serve.build_engine

    def capture(*args, **kw):  # keeps the engine the CLI builds
        built.append(build(*args, **kw))
        return built[-1]

    serve.build_engine = capture
    _reset_counts()  # counts of the CLI's real run only, from here
    t0 = time.perf_counter()
    try:
        data = cli("--real", "--dataset", "sharegpt", "--n", "8", "--json")
    finally:
        serve.build_engine = build
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    assert data["n_finished"] == 8 and data["scaling_migration_bytes"] == 0, data
    _expect_launches(counts, ("packed_flash_prefill_ring_chunk",
                              "paged_flash_decode_partial"), ())
    (eng,) = built
    done = eng.metrics.finished
    _oracle_parity(eng.model, eng.params, done, done, "serve CLI --real")
    print(f"[cli] serve --real --dataset sharegpt --n 8 (reduced lwm-7b, f32, on "
          f"the card): {data['n_finished']} finished, migration "
          f"{data['scaling_migration_bytes']} B, decode_iters {data['decode_iters']}, "
          f"wall {wall:.3f} s; launches {counts}; {len(done)} requests "
          "token-identical to the serial oracle")
    # the run's launches are K1-K3's at reduced width (checked in phase 2 at
    # these shapes): listed by path, not added to the rows timed at lwm-7b width
    for key, name in (("K1", "packed_flash_prefill"),
                      ("K3", "packed_flash_prefill_ring_chunk"),
                      ("K2", "paged_flash_decode_partial")):
        rec[key]["launches_by_path"]["serve CLI --real (phase 14)"] = counts.get(name, 0)
    del eng, built, done
    for system in serve.SYSTEMS:
        data = cli("--system", system, "--dataset", "sharegpt", "--rate", "2",
                   "--n", "12", "--json")
        assert data["n_finished"] > 0, (system, data)
        if system == "loongserve":
            assert data["n_finished"] == 12 and data["scaling_migration_bytes"] == 0
        print(f"[cli] serve --system {system} (sim, H100 cost model, n 12): "
              f"{data['n_finished']} finished, {data['rejected']} rejected, "
              f"norm_e2e_mean {data['norm_e2e_mean']:.6f} s/token")


def _paged_layout(rng, lens, page, n_layers, kvh, d, device):
    """One instance's paged pool holding ``lens`` cached tokens per request
    (dense local order, exclusive pages, page 0 left empty): (k_pages,
    v_pages [L, n_pages, page, KVH, D] f32, table [B, max_pages] int32,
    lengths [B] int32)."""
    import torch

    need = [-(-n // page) for n in lens]
    n_pages = sum(need) + 1
    table = np.zeros((len(lens), max(need)), np.int32)
    start = 1
    for b, k in enumerate(need):
        table[b, :k] = np.arange(start, start + k)
        start += k
    shape = (n_layers, n_pages, page, kvh, d)
    kp = torch.randn(shape, device=device)
    vp = torch.randn(shape, device=device)
    return (kp, vp, torch.as_tensor(table, device=device),
            torch.as_tensor(np.asarray(lens, np.int32), device=device))


def phase_mesh(card, rec, lens4):
    """Phase 15: the mesh executor on NCCL.  The card's machine holds one
    card and NCCL takes one rank per device, so the world here is one rank:
    the SPMD programs run their per-rank kernels and their collectives on a
    one-rank group, and the serving engine's mesh aliases every instance
    onto the one data coordinate (the executor replays in process, as the
    reference's does).  Multi-rank runs are four-card work."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.core import esp
    from repro_torch.core.paged_decode import PagedDecodeAttnImpl
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_flash_prefill import packed_flash_prefill_plain
    from repro_torch.launch.mesh import init_process_group, make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Cache, DefaultAttnImpl

    t0 = time.perf_counter()
    backend = init_process_group("cuda")
    mesh = make_test_mesh(1, 1, device="cuda")
    print(f"[mesh] process group: backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"on {card}; init {time.perf_counter() - t0:.2f} s")
    assert backend == "nccl" and dist.get_world_size() == 1
    cfg = get_config("lwm-7b")
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(15)
    torch.manual_seed(15)
    rng = np.random.default_rng(15)
    log = ["[mesh] SPMD programs at one rank vs their plain versions "
           f"(lwm-7b width H {h} / KVH {kvh}, D {d}):"]
    _reset_counts()  # the direct calls' collectives, from here

    # paged_decode_spmd at phase 4's decode batch (its 8 prompts as cached
    # lengths, page size 16, f32 pool as the engine's mirror)
    b = len(lens4)
    kp, vp, bt, ln = _paged_layout(rng, lens4, 16, 1, kvh, d, "cuda")
    q = torch.randn(b, 1, h, d, device="cuda")
    kn = torch.randn(b, 1, kvh, d, device="cuda")
    vn = torch.randn(b, 1, kvh, d, device="cuda")
    qpos = ln.clone()
    want = ref.paged_decode_merge_ref(q, kn, vn, [(kp[0], vp[0], bt, ln, None)],
                                      query_pos=qpos)
    for overlap in (True, False):
        got = esp.paged_decode_spmd(mesh, q, kn, vn, qpos, kp[0], vp[0], bt, ln,
                                    overlap=overlap)
        _check(f"paged_decode_spmd B {b}, contexts {min(lens4)}-{max(lens4)}, "
               f"overlap {overlap}", got, want, log)
    spmd_ms = _time_ms(lambda: esp.paged_decode_spmd(
        mesh, q, kn, vn, qpos, kp[0], vp[0], bt, ln))
    impl = PagedDecodeAttnImpl()

    def loop_merge():  # the in-process per-shard merge of the same layer
        from repro_torch.core.paged_decode import PagedShard

        impl.begin_step([PagedShard(kp, vp, bt, ln)])  # one layer plane
        try:
            return impl.decode_attn(q, None, None, kn, vn, qpos, window=None,
                                    softcap=None)
        finally:
            impl.end_step()

    loop_ms = _time_ms(loop_merge)
    log.append(f"  paged_decode_spmd {spmd_ms:.4f} ms per layer (K2, pmax, psum "
               f"on a one-rank NCCL group, new-token merge) vs the in-process "
               f"per-shard merge {loop_ms:.4f} ms (eager, events)")

    # ring_packed_prefill_spmd at n == 1 is K1: phase 4's first four prompts
    # packed, bf16 (the tensor-core route)
    lens_p = lens4[:4]
    t = -(-sum(lens_p) // 128) * 128
    off = _offsets(lens_p, len(lens_p))
    qq = torch.randn(t, h, d, device="cuda", dtype=torch.bfloat16)
    kk = torch.randn(t, kvh, d, device="cuda", dtype=torch.bfloat16)
    vv = torch.randn(t, kvh, d, device="cuda", dtype=torch.bfloat16)
    got = esp.ring_packed_prefill_spmd(mesh, qq, kk, vv, off)
    _check(f"ring_packed_prefill_spmd n 1 (K1), {len(lens_p)} prompts / {t} "
           "tokens, bf16", got, packed_flash_prefill_plain(qq, kk, vv, off), log,
           v=vv)
    del qq, kk, vv, got

    # paged_decode_iteration_spmd: full width, 2 layers, f32, phase 4's batch
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = build_model(cfg2, device="cuda")
    params = init_params(cfg2, gen, "cuda")
    kp, vp, bt, ln = _paged_layout(rng, lens4, 16, 2, kvh, d, "cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, b), device="cuda")
    route = torch.arange(b, device="cuda")[None]
    model.attn_impl = PagedDecodeAttnImpl()
    ids, k_rt, v_rt = esp.paged_decode_iteration_spmd(
        mesh, model, model.attn_impl, params, toks, ln, kp, vp, bt, ln, None,
        route)

    class PlainPaged(DefaultAttnImpl):  # plain K2 + merge over the same pool
        li = 0

        def decode_attn(self, q_, kc, vc, k_new, v_new, cache_len, *, window,
                        softcap):
            li, self.li = self.li, self.li + 1
            return ref.paged_decode_merge_ref(
                q_, k_new, v_new, [(kp[li], vp[li], bt, ln, None)],
                query_pos=ln).to(q_.dtype)

    model.attn_impl = PlainPaged()
    logits, _, kvs = model.decode(params, toks, Cache(length=ln))
    want_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    assert torch.equal(ids, want_ids), (ids, want_ids)
    _check("paged_decode_iteration_spmd 2 layers f32: routed new K", k_rt, kvs[0], log)
    _check("paged_decode_iteration_spmd 2 layers f32: routed new V", v_rt, kvs[1], log)
    log.append(f"  paged_decode_iteration_spmd: sampled ids {ids.tolist()} equal "
               "the plain decode's argmax")
    del model, params, kp, vp
    direct = dict(ops.dispatch_counts)
    direct_bytes = dict(ops.comm_bytes)
    log.append(f"  collectives of these calls: dispatches "
               f"{ {k: v for k, v in direct.items() if k in COLLECTIVES} }, "
               f"bytes {direct_bytes}")
    print("\n".join(log))
    for key in ("pmax", "psum", "all_gather"):
        assert direct.get(key, 0) > 0, (key, direct)
    gc.collect()
    torch.cuda.empty_cache()

    # the engine on the mesh executor: full width, 16 of 32 layers, bf16,
    # phase 4's requests; then the f32 token parity of phase 5's
    cfg16 = dataclasses.replace(cfg, n_layers=16)
    m, counts, dispatch, wall, spans = _serve(cfg16, 4, 4096, lens4, 16, 0, False,
                                              executor="mesh")
    _report("lwm-7b 16/32 layers bf16, executor=\"mesh\"", cfg16, m, counts,
            dispatch, wall, spans, lens4, 16)
    print(f"[mesh] serving: collective dispatches "
          f"{ {k: v for k, v in dispatch.items() if k in COLLECTIVES} } (the "
          "one-rank mesh aliases every instance: the executor replays in process)")
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    lens2 = [int(x) for x in np.random.default_rng(1).integers(128, 1025, 6)]
    _, counts2, _, wall2, _ = _serve(cfg2, 4, 2048, lens2, 8, 1, True,
                                     executor="mesh")
    print(f"[mesh] parity: lwm-7b width, 2 layers, f32, executor=\"mesh\": "
          f"{len(lens2)} requests token-identical to the serial oracle; "
          f"launches {counts2}; wall {wall2:.3f} s")
    for key, name in (("K1", "packed_flash_prefill"),
                      ("K3", "packed_flash_prefill_ring_chunk"),
                      ("K2", "paged_flash_decode_partial")):
        n = counts.get(name, 0) + counts2.get(name, 0)
        assert n > 0, (name, counts, counts2)
        rec[key]["launches_by_path"]["mesh executor (phase 15)"] = n
        rec[key]["launches"] += n
    dist.destroy_process_group()


# ------------------------------------------------- K4 backward (phases 2-3)

TOL_BWD_F32 = 2e-4  # times max|plain|: f32 sums over thousands of keys or queries
# a bf16 gradient is the f32 one rounded once (2^-7 max|plain|); its mean
# error stays within 1e-3 max|plain|
TOL_BWD_BF16, TOL_BWD_MEAN = 2.0 ** -7, 1e-3
TOL_LSE = 1e-4  # the forward's row LSE against the plain one


def _plain_lse(q, k, v, qp, kp, kw, rows):
    """The plain forward's row LSE [B, H, Sq], in q-row blocks (the rows of
    q are independent given their positions)."""
    import torch

    from repro_torch.kernels import ref

    return torch.cat([ref.striped_flash_attention_ref_lse(
        q[:, i:i + rows], k, v, qp[i:i + rows], kp, **kw)[1]
        for i in range(0, q.shape[1], rows)], dim=2)


def _check_bwd(name, got, want, log, bf16, gate=True):
    """Hold (dq, dk, dv) against the plain backward per tensor; returns the
    largest max abs error.  ``gate=False`` only logs (a witness)."""
    worst = 0.0
    for g, w, t in zip(got, want, ("dq", "dk", "dv")):
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        diff = (g - w).abs()
        err, mean = diff.max().item(), diff.mean().item()
        tol = (TOL_BWD_BF16 if bf16 else TOL_BWD_F32) * scale
        ok = err <= tol and not bool(g.isnan().any())
        note = f"max_abs_err {err:.3e} (tol {tol:.3e}"
        if bf16:
            ok = ok and mean <= TOL_BWD_MEAN * scale
            note += f"; mean {mean:.3e}, tol {TOL_BWD_MEAN * scale:.3e}"
        log.append(f"  K4 bwd {name} {t}: {note})")
        if gate and not ok:
            print("\n".join(log))
            raise AssertionError(f"K4 bwd {name} {t}: kernel disagrees with its "
                                 "plain version")
        worst = max(worst, err)
    return worst


def _bwd_build_report(log):
    """The K4 backward's ``-Xptxas -v`` lines and HGMMA counts: every
    tensor-core kernel (``*_tc_kernel``, the bf16 route) has HGMMA, no
    spills and no wgmma serialized by ptxas; the f32 kernels have none."""
    from repro_torch.kernels import _build

    name = "striped_attention_bwd"
    bad = []
    report = _build.ptxas_reports.get(name)
    if report is not None:  # built in this process
        kernels, serialized = _ptxas_kernels(report)
        for kern, (used, spill) in kernels.items():
            log.append(f"  [ptxas {name}] {kern}: {used}; {spill}")
            if "_tc_" in kern and not ("0 bytes spill stores" in spill
                                       and "0 bytes spill loads" in spill):
                bad.append(f"{kern} spills")
        log.extend(f"  [ptxas {name}] {line}" for line in serialized)
        bad.extend(serialized)
    hgmma = _sass_counts(_build._lib_path(name), "HGMMA")
    if hgmma is None:
        log.append("  [sass] cuobjdump not found: HGMMA not counted")
    else:
        log.append("  [sass] HGMMA instructions per kernel: "
                   + ", ".join(f"{k} {n}" for k, n in sorted(hgmma.items())))
        bad.extend(f"{k}: {n} HGMMA" for k, n in hgmma.items() if (n > 0) != ("_tc_" in k))
    if bad:
        print("\n".join(log))
        raise AssertionError(f"K4 backward build: {bad}")


def phase_k4_backward(rec, card):
    """The K4 backward (csrc/striped_attention_bwd.cu): the forward's row
    LSE and the backward against the plain backward formula (phase 2) at
    the widths of the training path and small variants, and its time
    (phase 3) at the lwm-7b train shape and mixtral width."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import striped_attention as sa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    log = ["[check] K4 backward vs the plain backward formula (TF32 off; bf16 "
           "cases, on wgmma, against the plain formula on the f32 upcast of the "
           "same inputs, with the kernel's own o and LSE; every bf16 case run "
           "twice and held bitwise equal)"]
    _bwd_build_report(log)
    bf16, f32 = torch.bfloat16, torch.float32
    ar = np.arange
    # (tag, B, Sq, Sk, H, KVH, D, dtype, causal, window, softcap, positions)
    cases = [
        ("lwm-7b B=2 S=4096", 2, 4096, 4096, 32, 32, 128, bf16, True, None, None,
         (ar(4096), ar(4096))),
        ("lwm-7b B=2 S=4096 f32", 2, 4096, 4096, 32, 32, 128, f32, True, None,
         None, (ar(4096), ar(4096))),
        ("mixtral S=6144 window=4096", 1, 6144, 6144, 32, 8, 128, bf16, True, 4096,
         None, (ar(6144), ar(6144))),
        ("glm4 GQA 16 S=2048", 1, 2048, 2048, 32, 2, 128, bf16, True, None, None,
         (ar(2048), ar(2048))),
        ("zamba2 D=80 S=4096", 1, 4096, 4096, 32, 32, 80, bf16, True, None, None,
         (ar(4096), ar(4096))),
        ("whisper B=4 S=448", 4, 448, 448, 6, 6, 64, bf16, True, None, None,
         (ar(448), ar(448))),
        ("train CLI reduced D=32 f32", 4, 128, 128, 4, 4, 32, f32, True, None, None,
         (ar(128), ar(128))),
        ("softcap D=80 B=2", 2, 257, 257, 32, 32, 80, bf16, True, None, 30.0,
         (ar(257), ar(257))),
        ("non-causal Sq=300 Sk=500 f32", 2, 300, 500, 32, 8, 128, f32, False, None,
         None, (ar(300), ar(500))),
        ("striped q shard 3 / kv shard 1 of 4, window", 1, 512, 512, 32, 8, 128,
         bf16, True, 200, None, (ar(512) * 4 + 3, ar(512) * 4 + 1)),
        ("unsorted B=3 f32 window softcap", 3, 200, 333, 32, 8, 128, f32, True, 64,
         50.0, (rng.permutation(400)[:200], rng.permutation(400)[:333])),
        ("empty rows Sq=300 Sk=400", 2, 300, 400, 32, 8, 128, bf16, True, None,
         None, (ar(300), ar(400) + 100)),
    ]
    timed = {}
    worst = 0.0
    for tag, b, sq, sk, h, kvh, d, dt, causal, window, softcap, (qp, kp) in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        q, k, v, do = randn(b, sq, h, d), randn(b, sk, kvh, d), randn(b, sk, kvh, d), \
            randn(b, sq, h, d)
        qpd, kpd = (torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
                    for x in (qp, kp))
        kw = dict(causal=causal, window=window, softcap=softcap)
        rows = max(1, 2 ** 26 // (b * h * sk))  # ~256 MB f32 score blocks
        o, lse = sa._launch(q, k, v, qpd, kpd, lse=True, **kw)
        want_lse = _plain_lse(q.float(), k.float(), v.float(), qpd, kpd, kw, rows)
        fin = torch.isfinite(want_lse)
        same_empty = bool((torch.isfinite(lse) == fin).all() and (lse[~fin] > 0).all())
        lse_err = (lse[fin] - want_lse[fin]).abs().max().item()
        log.append(f"  K4 fwd {tag}: LSE max_abs_err {lse_err:.3e} (tol {TOL_LSE:g}), "
                   f"empty rows +inf {same_empty}")
        assert same_empty and lse_err <= TOL_LSE, (tag, lse_err, same_empty)
        got = sa._launch_bwd(q, k, v, o, do, lse, qpd, kpd, **kw)
        want = ref.striped_flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), o.float(), do.float(), lse, qpd, kpd,
            rows=rows, **kw)
        worst = max(worst, _check_bwd(tag, got, want, log, dt == bf16))
        if tag.startswith("empty rows"):  # queries before every key
            assert (got[0][:, :100] == 0).all() and (o[:, :100] == 0).all(), tag
            log.append(f"  K4 bwd {tag}: the 100 empty rows' o and dq are exact zeros")
        if dt == bf16:  # no atomics: a second call is bitwise equal
            again = sa._launch_bwd(q, k, v, o, do, lse, qpd, kpd, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), tag
            log.append(f"  K4 bwd {tag}: a second call is bitwise equal")
            del again
        if tag not in ("lwm-7b B=2 S=4096", "mixtral S=6144 window=4096"):
            del want
            continue
        pairs = _attended_pairs(qp, kp, causal, window) * b
        flops = 2 * 5 * d * pairs * h
        nbytes = (4 * b * sq * h * d + 4 * b * sk * kvh * d) * q.element_size() \
            + 4 * b * h * sq
        ms = _time_ms(lambda: sa._launch_bwd(q, k, v, o, do, lse, qpd, kpd, **kw), 3, 1)
        plain_ms = _time_ms(lambda: ref.striped_flash_attention_bwd_ref(
            q, k, v, o, do, lse, qpd, kpd, rows=rows, **kw), 1, 1)
        # yardstick: the backward alone of SDPA with the same mask, on the
        # GQA-expanded [B, H, S, D] layout
        q4 = q.transpose(1, 2).contiguous().requires_grad_(True)
        k4, v4 = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
                  .requires_grad_(True) for x in (k, v))
        if window is None:
            sdpa_kw = dict(is_causal=True)
        else:
            dd = qpd[:, None] - kpd[None, :]
            sdpa_kw = dict(attn_mask=(dd >= 0) & (dd < window))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw)
        do4 = do.transpose(1, 2).contiguous()
        # witness: SDPA's own bf16 gradients (its o and LSE) under the same
        # measure, GQA folded back onto the KV heads (printed, not a gate)
        lib = torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)
        lib = (lib[0].transpose(1, 2),
               *(x.transpose(1, 2).unflatten(2, (kvh, h // kvh)).float().sum(3)
                 for x in lib[1:]))
        _check_bwd(f"{tag} SDPA witness", lib, want, log, True, gate=False)
        del lib, want
        lib_ms = _time_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                      retain_graph=True), 3, 1)
        bound = max(flops / PEAK_BF16, nbytes / HBM_BPS) * 1e3
        by = "operations" if flops / PEAK_BF16 > nbytes / HBM_BPS else "bytes"
        timed[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          library_ms=lib_ms)
        print(f"[time {card}] K4 bwd {tag}: kernel {ms:.3f} ms (bf16 on wgmma; "
              f"previous design, earlier run: {PREV_MS['K4 bwd ' + tag]} ms), "
              f"{_rates(flops, ms, bound)} (5 products), plain {plain_ms:.3f} ms, "
              f"sdpa backward {lib_ms:.3f} ms, bound {bound:.4f} ms ({by}; "
              f"{flops / 1e9:.1f} GFLOP over {pairs} pairs, {nbytes / 1e6:.1f} MB)")
        del q4, k4, v4, out4, do4
    rec["K4 bwd"] = dict(
        name="striped_flash_attention_bwd", route="cuda",
        body="bf16: wgmma (dk/dv and dq grids); f32: fp32 FMAs",
        source="src/repro_torch/csrc/striped_attention_bwd.cu",
        replaces="src/repro/kernels/striped_attention.py:102",
        launches=0, max_abs_err=worst, **timed["lwm-7b B=2 S=4096"],
        at_mixtral_width=timed["mixtral S=6144 window=4096"])
    print("\n".join(log))
    torch.cuda.empty_cache()


# ------------------------------------------------------ phase 16: training

TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2, 4096, 8


def _direction(m, v, n_step):
    """AdamW's update direction m^ / (sqrt(v^) + eps) of given moments (f64)."""
    m, v = m.double(), v.double()
    return (m / (1 - 0.9 ** n_step)) / ((v / (1 - 0.95 ** n_step)).sqrt() + 1e-8)


def phase_train(card, rec):
    """Phase 16: (a) train full-width lwm-7b cut to 4 of its 32 layers
    (bf16 params, f32 moments, B 2 x S 4096, loss_chunk 1024, remat, lr 3e-4,
    8 steps on one fixed batch): the loss falls, K4's forward launches twice
    per layer and step (remat recomputes) and its backward once, K1, K2, K3
    and K5 not at all; (b) gradient parity at lwm-7b width, 2 layers, f32,
    B 1 x S 2048: one step through the kernels against the same step through
    the plain attention."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import striped_attention as sa
    from repro_torch.launch import steps

    dev = torch.device("cuda")
    # ---- (a) full width, 4 of 32 layers, bf16
    cfg = dataclasses.replace(get_config("lwm-7b"), n_layers=TRAIN_LAYERS)
    lr = 3e-4
    _, step = steps.make_train_step(cfg, None, lr=lr, loss_chunk=1024, remat=True)
    params = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(16))
    opt = steps.init_opt_state(params)
    n_params = sum(p.numel() for p in steps.tree_leaves(params))
    rng = np.random.default_rng(16)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
             "labels": torch.as_tensor(toks[:, 1:], device=dev)}
    bwd_events = []
    launch_bwd = sa._launch_bwd

    def timed_bwd(*a, **kw):  # CUDA events around each K4 backward call
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = launch_bwd(*a, **kw)
        ev[1].record()
        bwd_events.append(ev)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, splits = [], [], []
    _reset_counts()
    sa._launch_bwd = timed_bwd
    try:
        for _ in range(TRAIN_STEPS):
            spans = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch, spans=spans)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            spans["K4 backward"] = sum(a.elapsed_time(b_) for a, b_ in bwd_events)
            bwd_events.clear()
            splits.append(spans)
    finally:
        sa._launch_bwd = launch_bwd
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    n_fwd, n_bwd = 2 * TRAIN_LAYERS * TRAIN_STEPS, TRAIN_LAYERS * TRAIN_STEPS
    assert counts.get("striped_flash_attention", 0) == n_fwd, counts
    assert counts.get("striped_flash_attention_bwd", 0) == n_bwd, counts
    _expect_launches(counts, [], ["packed_flash_prefill",
                                  "packed_flash_prefill_ring_chunk",
                                  "paged_flash_decode_partial", "flash_decode_partial"])
    steady = slice(1, None)  # the first step also pays for allocation
    wall = float(np.mean(walls[steady]))
    mean = {k: float(np.mean([s[k] for s in splits[steady]])) for k in splits[0]}
    print(f"[train] lwm-7b full width, {TRAIN_LAYERS} of 32 layers "
          f"({n_params / 1e9:.3f} B params), bf16 params, f32 moments, B "
          f"{TRAIN_B} x S {TRAIN_S}, loss_chunk 1024, remat, lr {lr:g}, "
          f"{TRAIN_STEPS} steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({', '.join(f'{x:.4f}' for x in losses)}); max_memory_allocated "
          f"{peak:.2f} GiB")
    print(f"[train] wall per step (device-synchronized): first {walls[0]:.3f} s, "
          f"steps 2-{TRAIN_STEPS} mean {wall:.3f} s (min {min(walls[steady]):.3f}, "
          f"max {max(walls[steady]):.3f}); {TRAIN_B * TRAIN_S / wall:.0f} tokens/s; "
          f"split (ms, CUDA events, steps 2-{TRAIN_STEPS}): forward "
          f"{mean['forward']:.1f}, backward {mean['backward']:.1f} (K4 backward "
          f"{mean['K4 backward']:.1f}, {100 * mean['K4 backward'] / mean['backward']:.1f}%), "
          f"optimizer {mean['optimizer']:.1f}")
    print(f"[train] kernel launches {counts}")
    rec["K4"]["launches_by_path"]["train (phase 16)"] = n_fwd
    rec["K4"]["launches"] += n_fwd
    rec["K4 bwd"]["launches"] = n_bwd
    rec["K4 bwd"]["launches_by_path"] = {"train (phase 16)": n_bwd}
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) gradient parity: kernels against the plain attention, f32
    cfg2 = dataclasses.replace(get_config("lwm-7b"), n_layers=2, dtype="float32")
    params = convert.init_params(cfg2, torch.Generator(device=dev).manual_seed(17))
    rng = np.random.default_rng(17)
    toks = rng.integers(0, cfg2.vocab_size, (1, 2049))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
             "labels": torch.as_tensor(toks[:, 1:], device=dev)}
    outs = []
    for plain in (False, True):
        model, step = steps.make_train_step(cfg2, None, lr=lr, loss_chunk=1024,
                                            remat=True)
        if plain:  # the same step through the plain attention (no kernel)
            model.attn_impl = ref.PlainAttnImpl()
        outs.append(step(params, steps.init_opt_state(params), batch))
        del model, step
    (pk, ok_, mk), (pp, op, mp) = outs
    loss_rel = abs(float(mk["loss"]) - float(mp["loss"])) / abs(float(mp["loss"]))
    assert loss_rel <= 1e-5, (float(mk["loss"]), float(mp["loss"]))
    worst_m = worst_p = 0.0
    n_loose = n_all = 0
    flat = zip(steps.tree_leaves(ok_["m"]), steps.tree_leaves(op["m"]),
               steps.tree_leaves(ok_["v"]), steps.tree_leaves(op["v"]),
               steps.tree_leaves(pk), steps.tree_leaves(pp))
    for m_k, m_p, v_k, v_p, p_k, p_p in flat:
        scale = m_p.abs().max().item()
        e_m = (m_k - m_p).abs().max().item()
        assert e_m <= 1e-4 * scale, (e_m, scale)
        worst_m = max(worst_m, e_m / max(scale, 1e-30))
        # params within 1e-6 beyond lr x the difference of the two AdamW
        # directions their own moments give (ill-conditioned where a
        # gradient sits within ~100 eps of zero)
        du = (_direction(m_k, v_k, 1) - _direction(m_p, v_p, 1)).abs()
        n_loose += int((lr * du > 1e-6).sum())
        n_all += du.numel()
        excess = ((p_k.double() - p_p.double()).abs() - lr * du).max().item()
        assert excess <= 1e-6, excess
        worst_p = max(worst_p, (p_k - p_p).abs().max().item())
    assert n_loose <= 0.01 * n_all, (n_loose, n_all)
    print(f"[train] gradient parity, lwm-7b width, 2 layers, f32, B 1 x S 2048, one "
          f"step through K4 (forward + backward kernels) vs the plain attention: loss "
          f"{float(mk['loss']):.6f} vs {float(mp['loss']):.6f} (rel {loss_rel:.2e}, tol "
          f"1e-5); grad_norm {float(mk['grad_norm']):.6f} vs {float(mp['grad_norm']):.6f}; "
          f"new m worst max_abs_err / max|leaf| {worst_m:.2e} (tol 1e-4); new params "
          f"max abs diff {worst_p:.2e}, within 1e-6 beyond lr x the AdamW direction "
          f"difference of the two moments ({n_loose} of {n_all} elements have such a "
          "difference above 1e-6)")
    del outs, params, batch
    gc.collect()
    torch.cuda.empty_cache()


COLLECTIVES = ("ring_ppermute", "psum", "pmax", "psum_scatter", "all_gather",
               "ring_out_gather", "kv_gather", "broadcast", "result_broadcast",
               "decode_partial_home", "host_sync_broadcast")


# --------------------------------------- ESP bodies' kernels (phases 2-3)


def _plain_partial(q, k, v, qp, kp, causal, window, softcap, rows=1024):
    """The reference's ring-step partial in plain PyTorch (f32 scores, the
    dense position mask), in blocks of query rows."""
    import torch

    from repro_torch.models import attention as A

    parts = [A.partial_attention(q[:, i:i + rows], k, v,
                                 A.mask_from_positions(qp[i:i + rows], kp,
                                                       causal=causal, window=window),
                                 softcap=softcap)
             for i in range(0, q.shape[1], rows)]
    return A.Partial(*(torch.cat([p_[j] for p_ in parts], dim=1) for j in range(3)))


def phase_esp_kernels(rec, card):
    """The ESP bodies' kernels at their shapes (phases 2 and 3):
    `ops.attention_partial` (K4 with its row LSE as an unnormalized
    partial, its o in f32) at a 4-rank ring step of lwm-7b width (S_local
    4096, striped positions, q shard 0 against KV shard 1: its first row
    sees no key), of mixtral width with its 4096-token window and of
    pixtral width, and at whisper width on one rank (B 4, S 448); K5 at a decode mode-2
    shard of lwm-7b width (B 8, a 4096-key shard at k_pos_offset 12288 of a
    16384-token cache), with and without a window.  Each is held against
    its plain version and timed beside its bound and the one PyTorch call
    that computes the same function."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    log = ["[check] ESP bodies' kernels vs plain versions (TF32 off)"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    from repro_torch.kernels import striped_attention as sa

    ring = {}
    # (tag, B, S_local, ring size n, H, KVH, D, window, q shard, KV shard);
    # whisper's is its 448-token decoder prompt on one rank (mesh (1, 1))
    for tag, b, s_l, n, h, kvh, d, window, r, c in (
            ("lwm7b_S4096_shard0_vs_1", 1, 4096, 4, 32, 32, 128, None, 0, 1),
            ("mixtral_S4096_shard2_vs_1_window4096", 1, 4096, 4, 32, 8, 128, 4096, 2, 1),
            ("pixtral_S4096_shard2_vs_1", 1, 4096, 4, 32, 8, 128, None, 2, 1),
            ("whisper_B4_S448_one_rank", 4, 448, 1, 6, 6, 64, None, 0, 0)):
        q, k, v = randn(b, s_l, h, d), randn(b, s_l, kvh, d), randn(b, s_l, kvh, d)
        qp_np, kp_np = np.arange(s_l) * n + r, np.arange(s_l) * n + c
        qp = torch.as_tensor(qp_np, dtype=torch.int32, device=dev)
        kp = torch.as_tensor(kp_np, dtype=torch.int32, device=dev)
        kw = dict(causal=True, window=window, softcap=None)
        got = ops.attention_partial(q, k, v, qp, kp, **kw)
        assert got.o.dtype == torch.float32, (tag, got.o.dtype)  # never rounded to bf16
        want = _plain_partial(q, k, v, qp, kp, True, window, None)
        empty = want.l == 0
        assert bool((torch.isinf(got.m) == empty).all() and (got.l[empty] == 0).all()), tag
        n_empty = int(empty.sum())
        # the f32 o has no bf16 output rounding: 1e-4 + 2^-8 max|v| (P is
        # rounded to bf16 before P V), the bf16 entry's 2^-7 |plain| is gone
        err = _check(f"attention_partial {tag} (finalized, f32 o)",
                     _fin(got.o, got.l), _fin(want.o, want.l), log, v=v)
        o16 = sa.striped_flash_attention(q, k, v, qp, kp, **kw)
        err16 = (o16.float() - _fin(want.o, want.l)).abs().max().item()
        log.append(f"  attention_partial {tag}: the bf16-output entry on the same inputs "
                   f"(the ring's partial before the f32 output) {err16:.3e}")
        lse_w = want.m + torch.log(want.l)
        lse_err = (got.m[~empty] - lse_w[~empty]).abs().max().item()
        log.append(f"  attention_partial {tag}: m vs plain m + log l {lse_err:.3e} "
                   f"(tol 1e-3); {n_empty} empty (row, head) pairs give m = -inf, l = 0")
        assert lse_err <= 1e-3, lse_err
        rec["K4"]["max_abs_err"] = max(rec["K4"]["max_abs_err"], err)
        pairs = _attended_pairs(qp_np, kp_np, True, window) * b
        flops = 4 * h * d * pairs
        bytes_ = (b * s_l * h * d + 2 * b * s_l * kvh * d) * 2 + 2 * s_l * 4 \
            + b * s_l * h * (d + 2) * 4  # q, k, v, positions; o, m, l in f32
        ms = _time_ms(lambda: ops.attention_partial(q, k, v, qp, kp, **kw))
        plain_ms = _time_ms(lambda: _plain_partial(q, k, v, qp, kp, True, window, None),
                            2, 1)
        # one PyTorch call with the same function: memory-efficient SDPA with
        # the mask as an additive bias and its log-sum-exp (o, lse) = the
        # partial (o, m = lse, l = 1)
        q4 = q.transpose(1, 2)
        k4, v4 = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2) for x in (k, v))
        dd = qp[:, None] - kp[None, :]
        ok = dd >= 0
        if window is not None:
            ok &= dd < window
        bias = torch.zeros(ok.shape, dtype=bf16, device=dev).masked_fill(
            ~ok, float("-inf"))[None, None].expand(b, h, s_l, s_l)
        lib_name = "aten._scaled_dot_product_efficient_attention(attn_bias, lse)"
        try:
            lib_ms = _time_ms(lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, bias, True), 5, 1)
        except RuntimeError as e:
            lib_ms, lib_name = None, f"none ({str(e)[:60]})"
        bound = max(flops / PEAK_BF16, bytes_ / HBM_BPS) * 1e3
        by = "operations" if flops / PEAK_BF16 > bytes_ / HBM_BPS else "bytes"
        ring[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=lib_ms, max_abs_err=err, bf16_out_err=err16)
        lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "n/a"
        print(f"[time {card}] attention_partial (K4 + LSE) {tag}: kernel {ms:.3f} ms, "
              f"{_rates(flops, ms, bound)}, plain {plain_ms:.3f} ms, {lib_name} {lib}, "
              f"bound {bound:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP over {pairs} pairs, "
              f"{bytes_ / 1e6:.1f} MB)")
        del q4, k4, v4, bias, dd, ok
    rec["K4"]["at_esp_ring_step"] = ring

    shard = {}
    b, h, kvh, d, s, off, total = 8, 32, 32, 128, 4096, 12288, 16384
    q = randn(b, 1, h, d)
    k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
    lens = [total] * b
    ln = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    for tag, window in (("lwm7b_B8_shard4096_at12288", None),
                        ("lwm7b_B8_shard4096_at12288_window4096", 4096)):
        kw = dict(k_pos_offset=off, window=window, softcap=None)
        err = _check(f"K5 mode-2 shard {tag}", fd.flash_decode_partial(q, k, v, ln, **kw),
                     fd.flash_decode_partial_plain(q, k, v, ln, **kw), log)
        rec["K5"]["max_abs_err"] = max(rec["K5"]["max_abs_err"], err)
        n_valid = _valid_keys(lens, s, off, window)
        nbytes = (2 * n_valid * kvh * d * 2 + b * h * d * 2 + b * h * (d + 2) * 4 + b * 4)
        flops = 4 * h * d * n_valid
        n_cp = max(2, -(-COLD_BYTES // (k.nbytes + v.nbytes)))
        kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n_cp - 1)]
        ms, how = _device_ms(lambda i: fd.flash_decode_partial(q, *kvs[i % n_cp], ln, **kw))
        plain_ms = _time_ms(lambda: fd.flash_decode_partial_plain(q, k, v, ln, **kw), 5)
        lib_ms, lib_how, lib_name = _k5_flash(q, kvs, ln, s, off, window, log, tag)
        bound = max(nbytes / HBM_BPS, flops / PEAK_BF16) * 1e3
        by = "bytes" if nbytes / HBM_BPS >= flops / PEAK_BF16 else "operations"
        shard[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          library_ms=lib_ms)
        print(f"[time {card}] K5 mode-2 shard {tag}: kernel {ms:.4f} ms ({how}, cold L2), "
              f"{100 * bound / ms:.1f}% of its bound, plain {plain_ms:.4f} ms, "
              f"{lib_name} {lib_ms:.4f} ms ({lib_how}), bound {bound:.5f} ms ({by}; "
              f"{n_valid} valid keys, {nbytes / 1e6:.2f} MB)")
        del kvs
    rec["K5"]["at_esp_decode_shard"] = shard
    print("\n".join(log))
    torch.cuda.empty_cache()


# ------------------------------------- phase 17: the mesh-aware model path


MESH_LAYERS = 4  # lwm-7b depth in phase 17 (of 32)
ZAMBA_LAYERS = 12  # zamba2-2.7b depth in phase 17 (2 of its 9 superblocks)
# phase 17's serving cases: (arch, layers (None: full depth), batch, prompt
# tokens (the text after the image for vlm), image embeddings, decode steps)
MESH_SERVE = (("lwm-7b", MESH_LAYERS, 1, 8192, 0, 16),
              ("zamba2-2.7b", ZAMBA_LAYERS, 1, 4096, 0, 8),
              ("mixtral-8x7b", 2, 1, 8192, 0, 8),  # S 8192: the 4096 window bites
              ("pixtral-12b", 4, 1, 3072, 1024, 8),
              ("whisper-tiny", None, 4, 448, 0, 16))  # 4 x 1500 encoder frames
# phase 17's ZeRO-1 train cases: (arch, layers, batch, tokens).  mixtral
# trains one layer: a step holds the old and the new f32 AdamW moments at
# once, which for two layers' experts (2.8 B parameters) alone is ~90 GB
MESH_TRAIN = (("lwm-7b", MESH_LAYERS, 2, 4096), ("mixtral-8x7b", 1, 1, 4096),
              ("whisper-tiny", None, 4, 448))


def _mesh_decode_loop(step, cache, toks, n_steps, params, place, times):
    """``n_steps`` greedy decode steps; each step's new KV is written into
    the (padded) cache at the row's length, as the pool would.  Appends
    each step's wall (s, device synchronized) to ``times``."""
    import torch

    out_tokens = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = step(place("tokens", toks), {k: place(k, v) for k, v in cache.items()}, params)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        toks = _plain(o["next_token"]).to(torch.int32)
        out_tokens.append(toks.cpu())
        ln = cache["length"]
        if "k" in cache:
            nk, nv = _plain(o["new_k"]), _plain(o["new_v"])
            for b in range(toks.shape[0]):
                cache["k"][:, b, int(ln[b])] = nk[:, b, 0]
                cache["v"][:, b, int(ln[b])] = nv[:, b, 0]
        for key in ("ssm_h", "ssm_conv", "xl_c", "xl_n", "xl_m", "sl_c", "sl_n",
                    "sl_h", "sl_m"):
            if key in o:
                cache[key] = _plain(o[key])
        cache["length"] = _plain(o["length"]).to(torch.int32)
    return out_tokens


def _plain(x):
    from repro_torch.launch.steps import full_value

    return full_value(x)


def _close(tag, got, want, log, rel=2e-2, extra=0.0):
    """A bf16 model output of the mesh step against the ``mesh=None``
    step's: within ``rel`` x max|want| + ``extra`` (one card runs the same
    kernels, so it is near-exact; bf16 rounding bounds what may move)."""
    got, want = _plain(got).float(), _plain(want).float()
    err = (got - want).abs().max().item()
    tol = rel * max(want.abs().max().item(), 1e-6) + extra
    log.append(f"  {tag}: max abs diff {err:.3e} (tol {tol:.3e})")
    assert err <= tol, (tag, err, tol)


def _mesh_cfg(arch, layers):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def _mesh_batch(cfg, rng, b, s, n_img, dev):
    """A prompt batch of ``b`` rows: ``s`` text tokens, plus ``n_img``
    image embeddings (vlm) or the encoder frames (audio), bf16, from
    ``rng``."""
    import torch

    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                       dtype=torch.int32, device=dev)}
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if n_img:
        batch["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(b, n_img, cfg.d_model)) * 0.05, dtype=dt, device=dev)
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) * 0.05, dtype=dt,
            device=dev)
    return batch


def phase_mesh_model(card, rec):
    """Phase 17: the mesh-aware steps (`launch.steps` on a `DeviceMesh`:
    parameters, inputs and optimizer state as DTensors, `ESPAttnImpl` /
    `ShardedAttnImpl` through `local_map`) on NCCL at world size 1, mesh
    (1, 1), against the ``mesh=None`` steps, full width in bf16
    (`MESH_SERVE`, `MESH_TRAIN`): lwm-7b cut to 4 of its 32 layers (prefill
    B 1 x S 8192, 16 decode steps, 2 ZeRO-1 train steps at B 2 x S 4096),
    zamba2-2.7b cut to 2 of its 9 superblocks (prefill B 1 x S 4096, 8
    decode steps), mixtral-8x7b cut to 2 of its 32 layers (prefill B 1 x S
    8192 under its 4096-token window, 8 decode steps; 2 train steps of one
    layer at B 1 x S 4096; `apply_moe` on the mesh drops the same fraction of
    assignments as without it), pixtral-12b cut to 4 of its 40 layers
    (1024 image embeddings + 3072 text tokens, 8 decode steps) and
    whisper-tiny at full depth (B 4 x 1500 frames, a 448-token prompt, 16
    decode steps, 2 train steps).  Tokens equal, caches / losses /
    parameters within bf16 tolerances, K4 (forward and backward) and K5
    launched, K1-K3 not."""
    t_ph = time.perf_counter()
    from torch.distributed.tensor import DTensor  # noqa: F401
    from torch.distributed.tensor.experimental import local_map  # noqa: F401
    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_process_group, make_test_mesh

    print(f"[mesh-model] torch {torch.__version__}: DTensor and local_map import")
    assert init_process_group("cuda") == "nccl" and dist.get_world_size() == 1
    mesh = make_test_mesh(1, 1, device="cuda")
    dev = torch.device("cuda")
    log = [f"[mesh-model] mesh (1, 1) on NCCL vs mesh=None, {card}:"]
    launches, wall = {}, {}

    def placer(cfg, kind, b, s):
        ish = steps.input_shardings(cfg, ShapeSpec("smoke", kind, s, b), mesh)

        def place(key, x):
            spec = ish["tokens"] if key == "tokens" else ish["cache"][key]
            return shlib.distribute(x, mesh, spec)
        return place

    def timed(fn):
        """(result, wall s) of one call, the device synchronized."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def split(ts):
        """(first call, median of the later calls) in ms."""
        return 1e3 * ts[0], 1e3 * float(np.median(ts[1:]))

    for arch, layers, b, s_txt, n_img, n_dec in MESH_SERVE:
        cfg = _mesh_cfg(arch, layers)
        depth = f"{cfg.n_layers} layers" if layers else "full depth"
        params = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(17))
        pp = steps.place_params(cfg, mesh, params)
        rng = np.random.default_rng(17)
        prompt = _mesh_batch(cfg, rng, b, s_txt, n_img, dev)
        s_pre = s_txt + n_img
        pos = torch.arange(s_pre, dtype=torch.int32, device=dev)
        _, ref_pre = steps.make_prefill_step(cfg, None)
        _, mesh_pre = steps.make_prefill_step(cfg, mesh)
        _, ref_dec = steps.make_decode_step(cfg, None)
        _, mesh_dec = steps.make_decode_step(cfg, mesh)
        ref_t, mesh_t = [], []
        for _ in range(2):  # the second call of each is the steady state
            (nt_ref, c_ref), t_ = timed(lambda: ref_pre(prompt, pos, params))
            ref_t.append(t_)
        ish = steps.input_shardings(cfg, ShapeSpec("smoke", "prefill", s_pre, b), mesh)
        batch = shlib.distribute(prompt, mesh, ish["batch"])
        positions = shlib.distribute(pos, mesh, ish["positions"])
        _reset_counts()
        (nt, c), t_ = timed(lambda: mesh_pre(batch, positions, pp))
        launches[f"{arch} prefill"] = _kernel_counts()
        mesh_t.append(t_)
        mesh_t.append(timed(lambda: mesh_pre(batch, positions, pp))[1])
        wall[f"{arch} prefill B {b} x S {s_pre}"] = (ref_t, mesh_t)
        assert torch.equal(_plain(nt).cpu(), nt_ref.cpu()), (arch, nt, nt_ref)
        if c_ref.k is not None:
            _close(f"{arch} prefill cache k", c.k, c_ref.k, log)
            _close(f"{arch} prefill cache v", c.v, c_ref.v, log)
        if c_ref.cross_k is not None:
            _close(f"{arch} prefill cross k", c.cross_k, c_ref.cross_k, log)
            _close(f"{arch} prefill cross v", c.cross_v, c_ref.cross_v, log)
        if cfg.family == "hybrid":
            _close(f"{arch} prefill ssm h", c.ssm.h, c_ref.ssm.h, log)
        if cfg.family == "moe":
            _mesh_moe_dropped(cfg, params, pp, mesh, prompt["tokens"], log)

        def dcache(cc):
            pad = torch.zeros((cc.k.shape[0], b, s_pre + n_dec) + tuple(cc.k.shape[3:]),
                              dtype=cc.k.dtype, device=dev)
            k, v = pad.clone(), pad.clone()
            k[:, :, :s_pre], v[:, :, :s_pre] = _plain(cc.k), _plain(cc.v)
            out = {"k": k, "v": v, "length": torch.full((b,), s_pre, dtype=torch.int32,
                                                        device=dev)}
            if cfg.family == "hybrid":
                out["ssm_h"], out["ssm_conv"] = _plain(cc.ssm.h), _plain(cc.ssm.conv)
            if cc.cross_k is not None:
                out["cross_k"], out["cross_v"] = _plain(cc.cross_k), _plain(cc.cross_v)
            return out

        first = nt_ref.to(torch.int32)
        ref_t, mesh_t = [], []
        ref_toks = _mesh_decode_loop(ref_dec, dcache(c_ref), first, n_dec, params,
                                     lambda _k, x: x, ref_t)
        _reset_counts()
        mesh_toks = _mesh_decode_loop(mesh_dec, dcache(c), first, n_dec, pp,
                                      placer(cfg, "decode", b, s_pre + n_dec), mesh_t)
        launches[f"{arch} decode"] = _kernel_counts()
        wall[f"{arch} decode step B {b}"] = (ref_t, mesh_t)
        assert all(torch.equal(a, b_) for a, b_ in zip(mesh_toks, ref_toks)), \
            (arch, mesh_toks, ref_toks)
        log.append(f"  {arch} ({depth}, bf16): prefill B {b} x S {s_pre} tokens and "
                   f"{n_dec} decode tokens per row equal the mesh=None steps' "
                   f"(row 0: {[int(t_[0]) for t_ in mesh_toks]})")
        del params, pp, c, c_ref, prompt, batch
        gc.collect()
        torch.cuda.empty_cache()

    for arch, layers, b, s in MESH_TRAIN:
        _mesh_train(arch, _mesh_cfg(arch, layers), b, s, mesh, dev, timed, launches,
                    wall, log)
    print("\n".join(log))
    for tag, cnt in launches.items():
        print(f"[mesh-model] {tag} (mesh (1, 1)): launches {cnt}")
    for tag, (ref_t, mesh_t) in wall.items():
        r1, r2 = split(ref_t)
        m1, m2 = split(mesh_t)
        print(f"[time {card}] phase 17 {tag} (host clock, device synchronized; first "
              f"call / median of the later {len(mesh_t) - 1}): mesh=None {r1:.1f} / "
              f"{r2:.1f} ms, mesh (1, 1) {m1:.1f} / {m2:.1f} ms ({m2 / r2:.2f}x "
              "steady)")
    k4 = sum(c.get("striped_flash_attention", 0) for c in launches.values())
    k4b = sum(c.get("striped_flash_attention_bwd", 0) for c in launches.values())
    k5 = sum(c.get("flash_decode_partial", 0) for c in launches.values())
    assert k4 > 0 and k5 > 0 and k4b > 0, launches
    for tag, c in launches.items():
        _expect_launches(c, [], ["packed_flash_prefill", "packed_flash_prefill_ring_chunk",
                                 "paged_flash_decode_partial"])
        if "train" in tag:
            assert c.get("striped_flash_attention_bwd", 0) > 0, (tag, c)
        elif "prefill" in tag:
            assert c.get("striped_flash_attention", 0) > 0, (tag, c)
        elif "decode" in tag:
            assert c.get("flash_decode_partial", 0) > 0, (tag, c)
    rec["K4"]["launches_by_path"]["mesh-aware steps (phase 17)"] = k4
    rec["K4 bwd"]["launches_by_path"]["mesh-aware train (phase 17)"] = k4b
    rec["K5"]["launches_by_path"]["mesh-aware steps (phase 17)"] = k5
    for key, n in (("K4", k4), ("K4 bwd", k4b), ("K5", k5)):
        rec[key]["launches"] = rec[key].get("launches", 0) + n
    print(f"[phase 17] mesh-aware steps took {time.perf_counter() - t_ph:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_moe_dropped(cfg, params, pp, mesh, tokens, log):
    """Layer 0's `apply_moe` on the prompt's embeddings (S-major tokens),
    through the prefill constraints on the mesh and without a mesh, at the
    config's capacity factor and at 0.5 (where assignments drop): the same
    dropped fraction, the aux loss within 1e-5 relative, the outputs within
    bf16 tolerance."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import sharding as shlib
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    constrain = shlib.make_constrain(cfg, mesh, "prefill")
    with torch.no_grad(), implicit_replication():
        x = L.embed_lookup(params["embed"], tokens)
        flat = moe.tokens_s_major(x)
        xm = moe.tokens_s_major(constrain(shlib.distribute(x, mesh, shlib.P()), "act"))
        p0 = {k: v[0] for k, v in params["layers"]["moe"].items()}
        pm = {k: v[0] for k, v in pp["layers"]["moe"].items()}
        # the config's capacity factor, and one low enough that experts drop
        for cf in (cfg.moe_capacity_factor, 0.5):
            kw = dict(top_k=cfg.moe_top_k, capacity_factor=cf, ffn_kind=cfg.ffn_kind)
            ref = moe.apply_moe(p0, flat, **kw)
            got = moe.apply_moe(pm, xm, constrain=constrain, **kw)
            d_ref, d_got = float(ref.dropped_frac), float(got.dropped_frac)
            assert d_got == d_ref and (d_ref > 0 or cf > 1), (cf, d_got, d_ref)
            aux_ref, aux_got = float(ref.aux_loss), float(_plain(got.aux_loss))
            assert abs(aux_got - aux_ref) <= 1e-5 * aux_ref, (cf, aux_got, aux_ref)
            _close(f"{cfg.name} layer-0 apply_moe out (capacity factor {cf})", got.out,
                   ref.out, log)
            cap = moe.capacity(flat.shape[0], cfg.n_experts, cfg.moe_top_k, cf)
            log.append(f"  {cfg.name} layer-0 apply_moe over {flat.shape[0]} tokens, "
                       f"capacity factor {cf} (capacity {cap}): dropped_frac {d_got:.6f} "
                       f"on the mesh = {d_ref:.6f} without it; aux {aux_got:.6f} / "
                       f"{aux_ref:.6f}")


def _mesh_train(arch, cfg, b, s, mesh, dev, timed, launches, wall, log):
    """Two ZeRO-1 train steps of ``cfg`` on the mesh against two
    ``mesh=None`` steps on one fixed batch (labels: the tokens shifted by
    one): losses within 1e-3 relative (a moe model's second within 1e-2),
    every parameter leaf within bf16 tolerance plus the AdamW sign room."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps

    params = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(18))
    rng = np.random.default_rng(18)
    batch = _mesh_batch(cfg, rng, b, s, 0, dev)
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    _, ref_step = steps.make_train_step(cfg, None, loss_chunk=1024, remat=True)
    _, mesh_step = steps.make_train_step(cfg, mesh, loss_chunk=1024, remat=True)
    p_ref, o_ref = params, steps.init_opt_state(params)
    ref_losses, ref_t = [], []
    for _ in range(2):
        (p_ref, o_ref, met), t_ = timed(lambda: ref_step(p_ref, o_ref, batch))
        ref_losses.append(float(met["loss"]))
        ref_t.append(t_)
    del o_ref
    pp = steps.place_params(cfg, mesh, params, train=True)
    oo = steps.place_opt_state(cfg, mesh, steps.init_opt_state(params))
    del params
    ish = steps.input_shardings(cfg, ShapeSpec("smoke", "train", s, b), mesh)
    bt = shlib.distribute(batch, mesh, ish["batch"])
    _reset_counts()
    losses, mesh_t = [], []
    for _ in range(2):
        (pp, oo, met), t_ = timed(lambda: mesh_step(pp, oo, bt))
        losses.append(float(met["loss"]))
        mesh_t.append(t_)
    launches[f"{arch} train"] = _kernel_counts()
    wall[f"{arch} train step B {b} x S {s}"] = (ref_t, mesh_t)
    # step 1's losses agree to 1e-3; so do step 2's, but for moe: AdamW's
    # first step moves every parameter by +-lr, where g ~ 0 in either
    # direction, and the router's near-uniform top-2 at random init turns
    # such a flip into another expert for near-tie tokens, so step 2's loss
    # may move by more (the parameters stay within the rule below)
    for n, (a, b_) in enumerate(zip(losses, ref_losses)):
        rel = 1e-2 if (n and cfg.family == "moe") else 1e-3
        assert abs(a - b_) <= rel * abs(b_), (arch, n, losses, ref_losses)
    # where g ~ 0 the two AdamW directions may take opposite signs (each
    # step moves a parameter by up to lr (1 + wd) either way), and bf16
    # rounds every new parameter: 2 steps x 2 lr plus two bf16 steps
    for i, (a, b_) in enumerate(zip(steps.tree_leaves(pp), steps.tree_leaves(p_ref))):
        _close(f"{arch} train param leaf {i}", a, b_, log, rel=2.0 ** -6,
               extra=2 * 2 * 3e-4 * 1.01)
    log.append(f"  {arch} train (ZeRO-1 moments over data, 2 steps): losses "
               f"{losses} vs mesh=None {ref_losses}")
    m_leaf = steps.tree_leaves(oo["m"])[0]
    log.append(f"  moment placements {m_leaf.placements} (a DTensor: "
               f"{isinstance(m_leaf, DTensor)})")
    del pp, oo, p_ref
    gc.collect()
    torch.cuda.empty_cache()


# phase 18: the op census (`launch.census`) around phase 16 / 17's lwm-7b
# steps (full width, 4 of 32 layers, bf16, mesh=None)
CENSUS_LAYERS = 4
CENSUS_S = 8192  # the prefill's prompt (B 1)
CENSUS_DECODE = 16  # decode steps after it
CENSUS_TRAIN = (2, 4096)  # the train step's B x S (remat, loss_chunk 1024)
CENSUS_REPS = 5  # timed calls per step (the median is kept)
SHARE_MAX = 1.05  # the roofline's time over the measured one may not exceed


def _census_run(cfg, dev, params, rng, counted=None, times=None):
    """Phase 18's steps on ``dev`` (the card, or meta): a prefill of B 1 x
    S ``CENSUS_S``, ``CENSUS_DECODE`` greedy decode steps over its padded
    cache (each step's new KV written at the row's length, outside the
    census) and one train step, each kind under its own `Census`.  Returns
    {kind: census result}.  ``counted()`` is called after the census runs;
    with ``times`` (a dict), the same steps then run again without the
    census, ``CENSUS_REPS`` timed calls each (CUDA events; every decode step
    of a second loop), into ``times[kind]`` in ms."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.launch.census import Census

    meta = dev.type == "meta"

    def ints(shape):
        if meta:
            return torch.empty(shape, dtype=torch.int32, device=dev)
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                               dtype=torch.int32, device=dev)

    _, pre = steps.make_prefill_step(cfg, None, device=dev)
    _, dec = steps.make_decode_step(cfg, None, device=dev)
    _, trn = steps.make_train_step(cfg, None, loss_chunk=1024, remat=True,
                                   device=dev)
    cen = {k: Census() for k in ("prefill", "decode", "train")}
    prompt = {"tokens": ints((1, CENSUS_S))}
    pos = torch.arange(CENSUS_S, dtype=torch.int32, device=dev)
    with cen["prefill"]:
        nt, c = pre(prompt, pos, params)

    def dcache():
        pad = c.k.new_zeros((c.k.shape[0], 1, CENSUS_S + CENSUS_DECODE)
                            + tuple(c.k.shape[3:]))
        k, v = pad.clone(), pad.clone()
        k[:, :, :CENSUS_S], v[:, :, :CENSUS_S] = c.k, c.v
        return {"k": k, "v": v, "length": torch.full(
            (1,), CENSUS_S, dtype=torch.int32, device=dev)}

    def decode_loop(cache, census=None, ts=None):
        tok = nt.to(torch.int32)
        for _ in range(CENSUS_DECODE):
            ev = _events() if ts is not None else None
            with census if census is not None else contextlib.nullcontext():
                o = dec(tok, cache, params)
            if ev is not None:
                ts.append(_elapsed(ev))
            at = cache["length"].long()  # B 1: one row, written on the device
            cache["k"].index_copy_(2, at, o["new_k"])
            cache["v"].index_copy_(2, at, o["new_v"])
            cache["length"] = o["length"].to(torch.int32)
            tok = o["next_token"].to(torch.int32)

    decode_loop(dcache(), cen["decode"])
    b, s = CENSUS_TRAIN
    toks = ints((b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = steps.init_opt_state(params)
    with cen["train"]:
        trn(params, opt, batch)
    out = {k: c_.result() for k, c_ in cen.items()}
    if counted is not None:
        counted()
    if times is not None:
        times["prefill"] = _timed_calls(lambda: pre(prompt, pos, params))
        times["decode"] = []
        decode_loop(dcache(), ts=times["decode"])
        times["train"] = _timed_calls(lambda: trn(params, opt, batch))
    return out


def _events():
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    return ev


def _elapsed(ev) -> float:
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1])


def _timed_calls(fn, reps=CENSUS_REPS):
    """ms of ``reps`` calls (CUDA events; the outputs are dropped)."""
    ts = []
    for _ in range(reps):
        ev = _events()
        fn()
        ts.append(_elapsed(ev))
    return ts


def _run_example(name, log):
    """Run examples/``name`` on the card as a subprocess; returns its kernel
    launches (the "kernel launches:" line it prints)."""
    import os

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    p = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                       cwd=str(ROOT), env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, (name, p.stdout[-3000:], p.stderr[-3000:])
    lines = p.stdout.splitlines()
    launches = json.loads(next(l for l in lines if l.startswith(
        "kernel launches:")).split(":", 1)[1])
    parity = next(l for l in lines if l.startswith("token parity:"))
    assert lines[-1].startswith("OK"), (name, lines[-3:])
    log.append(f"  examples/{name}: rc 0 in {time.perf_counter() - t0:.1f} s; "
               f"{parity}; kernel launches {launches}")
    return launches


def phase_census(card, rec):
    """Phase 18: the op census (`repro_torch.launch.census`, the dry run's
    count of a step's work) around real steps on the card — lwm-7b at full
    width, 4 of 32 layers, bf16, ``mesh=None``: a prefill of B 1 x S 8192,
    16 decode steps and one train step of B 2 x S 4096 with remat.  K4's
    forward and backward and K5 must launch, and the census must count one
    kernel call per launch.  The same steps built on meta tensors must give
    identical FLOPs, bytes and kernel work.  Then each step's roofline
    (census FLOPs over 989e12 FLOP/s, census bytes over 3.35e12 B/s) against
    its measured steady-state time (CUDA events, median of 5 calls; every
    step of a second decode loop), the share max(compute, memory) /
    measured (above 1.05 fails the run) and `model_flops_estimate` /
    (measured x 989e12).  Then examples/torch_quickstart.py and
    examples/torch_elastic_scaling_demo.py run on the card as subprocesses:
    both exit 0, launch their kernels and check tokens against the serial
    oracle themselves."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    t_ph = time.perf_counter()
    cfg = dataclasses.replace(get_config("lwm-7b"), n_layers=CENSUS_LAYERS)
    dev = torch.device("cuda")
    params = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(18))
    times: dict = {}
    counts: dict = {}
    _reset_counts()
    got = _census_run(cfg, dev, params, np.random.default_rng(18),
                      lambda: counts.update(_kernel_counts()), times)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    want = _census_run(cfg, torch.device("meta"), dryrun.meta_params(cfg), None)
    log = [f"[census {card}] lwm-7b full width, {CENSUS_LAYERS} of 32 layers, "
           "bf16, mesh=None; rank 0 of one card:"]
    for kind in got:
        if got[kind] != want[kind]:
            raise AssertionError(f"phase 18: the census of the {kind} step on "
                                 f"the card {got[kind]} differs from the same "
                                 f"step's on meta {want[kind]}")
    k4 = counts.get("striped_flash_attention", 0)
    k4b = counts.get("striped_flash_attention_bwd", 0)
    k5 = counts.get("flash_decode_partial", 0)
    assert k4 > 0 and k4b > 0 and k5 > 0, counts
    _expect_launches(counts, [], ["packed_flash_prefill",
                                  "packed_flash_prefill_ring_chunk",
                                  "paged_flash_decode_partial"])
    seen = {}
    for r in got.values():
        for name, k in r["kernels"].items():
            seen[name] = seen.get(name, 0) + k["calls"]
    assert seen == {"K4": k4, "K4 bwd": k4b, "K5": k5}, (seen, counts)
    b_t, s_t = CENSUS_TRAIN
    shapes = {"prefill": ShapeSpec("prefill", "prefill", CENSUS_S, 1),
              "decode": ShapeSpec("decode", "decode",
                                  CENSUS_S + CENSUS_DECODE // 2, 1),
              "train": ShapeSpec("train", "train", s_t, b_t)}
    what = {"prefill": f"prefill B 1 x S {CENSUS_S}",
            "decode": f"decode step B 1 at {CENSUS_S}-{CENSUS_S + CENSUS_DECODE} "
                      "keys",
            "train": f"train step B {b_t} x S {s_t}, remat"}
    for kind, r in got.items():
        n_calls = CENSUS_DECODE if kind == "decode" else 1
        flops, nbytes = r["flops"] / n_calls, r["bytes"] / n_calls
        ms = float(np.median(times[kind][1:] if kind == "decode" else times[kind]))
        comp, mem = flops / PEAK_BF16, nbytes / HBM_BPS
        share = max(comp, mem) / (ms * 1e-3)
        mfu = dryrun.model_flops_estimate(cfg, shapes[kind]) / (ms * 1e-3 * PEAK_BF16)
        kern = {k: f"{v['calls'] // n_calls} calls, {v['flops'] / n_calls:.4e} "
                   f"FLOPs, {v['bytes'] / n_calls:.4e} B"
                for k, v in r["kernels"].items()}
        log.append(
            f"  {what[kind]}: census {flops:.6e} FLOPs, {nbytes:.6e} bytes "
            f"(equal on meta; kernels {kern}); roofline compute "
            f"{comp * 1e3:.3f} ms, memory {mem * 1e3:.3f} ms; measured "
            f"{ms:.3f} ms (CUDA events, median of "
            f"{len(times[kind]) - (kind == 'decode')}); share "
            f"max(compute, memory) / measured {share:.3f}; "
            f"model_flops_estimate / (measured x 989e12) {mfu:.4g}")
        assert share <= SHARE_MAX, (kind, share)
    for name in ("torch_quickstart.py", "torch_elastic_scaling_demo.py"):
        ex = _run_example(name, log)
        assert sum(ex.values()) > 0, (name, ex)
        for key, kname in (("K1", "packed_flash_prefill"),
                           ("K3", "packed_flash_prefill_ring_chunk"),
                           ("K2", "paged_flash_decode_partial")):
            rec[key]["launches_by_path"][f"examples/{name} (phase 18, a "
                                         "subprocess)"] = ex.get(kname, 0)
    print("\n".join(log))
    rec["K4"]["launches_by_path"]["census (phase 18)"] = k4
    rec["K4 bwd"]["launches_by_path"]["census (phase 18)"] = k4b
    rec["K5"]["launches_by_path"]["census (phase 18)"] = k5
    for key, n in (("K4", k4), ("K4 bwd", k4b), ("K5", k5)):
        rec[key]["launches"] = rec[key].get("launches", 0) + n
    print(f"[phase 18] census and examples took {time.perf_counter() - t_ph:.1f} s")


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
    phase_k4_backward(rec, smi.splitlines()[0])
    phase_esp_kernels(rec, smi.splitlines()[0])

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
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phases 12-14: xlstm-350m serving, ssm / audio parity, the CLI
    for key in ("K4", "K5"):
        rec[key]["launches_by_path"] = {"mixtral + zamba2 (phases 6-7)":
                                        rec[key]["launches"]}
    for n, phase in ((12, lambda: phase_xlstm_serve(card)),
                     (13, lambda: phase_ssm_audio_parity(card, rec)),
                     (14, lambda: phase_cli(card, rec)),
                     (15, lambda: phase_mesh(card, rec, lens)),
                     (16, lambda: phase_train(card, rec)),
                     (17, lambda: phase_mesh_model(card, rec)),
                     (18, lambda: phase_census(card, rec))):
        t_ph = time.perf_counter()
        phase()
        print(f"[phase {n}] took {time.perf_counter() - t_ph:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    order = ("K1", "K3", "K2", "K4", "K4 bwd", "K5")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rec[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
