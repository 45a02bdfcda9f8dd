#!/usr/bin/env python3
"""The mesh executor across the cards of one host, on NCCL.

    python3 tools/mesh_probe.py            # one rank per visible CUDA card
    python3 tools/mesh_probe.py --cpu 4    # 4 gloo ranks on the CPU, reduced width

Spawns one process per rank (rank r on card r) that opens the world with
`repro_torch.launch.mesh.init_process_group` and runs three phases over a
(world, 1) ("data", "model") mesh:

  1. ring: `core.esp.ring_packed_prefill_spmd` at lwm-7b width (H = KVH =
     32, D = 128, bf16) over the eight prompts of chip_smoke.py's phase 4
     packed on one token axis, with ``double_buffer`` on and off: held
     against plain K1 (`packed_flash_prefill_plain`) with chip_smoke's
     tensor-core tolerance, then timed (CUDA events around 10 calls after
     2 warm-ups, the slowest rank's), beside K1 over the whole batch on one
     card and one ring leg alone (`ops.ring_ppermute` of one KV stripe);
     on a card, one call of each arm is also traced on rank 0
     (torch.profiler): the span from its first kernel to its last, the
     time some kernel runs, the NCCL kernels' and the other kernels' time,
     and how much of the NCCL time overlaps other kernels;
  2. decode: `paged_decode_spmd` and the batch-sharded boundary
     `paged_decode_attn_sharded` at phase 4's decode batch (B 8, the
     prompts as cached lengths, page size 16, f32 pool), each rank holding
     the pool's round-robin token share of every request: held against
     `ref.paged_decode_merge_ref` / `ref.paged_decode_batch_sharded_ref`
     over all shares within 1e-4, and timed beside K2 + merge over the
     whole cache on one card;
  3. engine: `LoongServeEngine(..., mesh=...)` at lwm-7b width, 2 layers,
     f32, one instance per rank, serving phase 5's six requests (8 new
     tokens): every rank's tokens equal, and equal to the port's serial
     oracle; the run's dispatch counts and collective bytes.

  4. the mesh-aware model path (`launch.steps` on a `DeviceMesh`: DTensor
     parameters and inputs, `ESPAttnImpl`'s striped ring through
     `ops.attention_partial` and its multi-master decode through K5) on
     the meshes (world, 1) and, for an even world above 2, (2, world / 2):
     the prefill step at lwm-7b width (4 of 32 layers, bf16, B 1 x S
     16384, striped over the data ranks) and the decode step (B 8 at 16384
     cached tokens): logits within one bf16 rounding (2^-8 x max|logit|)
     per tensor-parallel product of the ``mesh=None`` step's on one card,
     and next tokens equal but where the one-card top two logits are a near
     tie the bf16 rounding may break; the slowest rank's time (CUDA events) beside one card's
     ``mesh=None`` step, and `ops.comm_bytes` per collective; then
     `ssm_sp.mamba2_forward_sp` (zamba2-2.7b width) and `mlstm_forward_sp`
     (xlstm-350m width) at B 2 x S 8192 on (world, 1) against their
     single-card forwards, timed the same way.

     Then three checks of the mesh steps' numerics: the ESP ring's merge in
     bf16 on rings of the world and of 2 ranks against one card's K4 over
     the whole sequence, with the ring steps' partials in f32 (the port)
     and rounded to bf16 (as before the LSE entry wrote f32); the (2,
     world / 2) logit check in f32, held to 1e-4 x max|logit| with every
     token equal; and mixtral-8x7b (2 layers, f32) on both meshes, expert-
     parallel over real collectives, tokens equal to one card's.

``--only 4`` runs phase 4 alone.  Rank 0 prints every phase; the last line
is a JSON summary.  Exits
non-zero if a phase fails, a rank hangs past the time limit, or (without
``--cpu``) there is no CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPS, WARMUP = 10, 2


def _cpu_tree(x, dev):
    import torch

    if isinstance(x, dict):
        return {k: _cpu_tree(v, dev) for k, v in x.items()}
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _timed(fn, group, dev):
    """Per-call ms of ``fn`` on this rank (events on a card, the host clock
    on the CPU), then the slowest rank's."""
    import torch
    import torch.distributed as dist

    for _ in range(WARMUP):
        fn()
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / REPS
    else:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / REPS
    t = torch.tensor([ms], dtype=torch.float32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _trace(fn):
    """Kernel timeline of one call of ``fn`` (torch.profiler, this rank):
    ms from the first kernel's start to the last kernel's end, ms in which
    some kernel runs, ms of NCCL kernels and of the others, and ms of NCCL
    time during which another kernel runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    nccl, other = [], []
    for e in prof.events():
        if getattr(e, "device_type", None) is None or "CUDA" not in str(e.device_type):
            continue
        iv = (e.time_range.start, e.time_range.end)
        (nccl if "nccl" in e.name.lower() else other).append(iv)
    if not nccl + other:
        return {}
    n_m, o_m, all_m = _merge(nccl), _merge(other), _merge(nccl + other)
    inter = 0.0
    for a, b in n_m:
        for c, d in o_m:
            inter += max(0.0, min(b, d) - max(a, c))
    span = max(b for _, b in all_m) - min(a for a, _ in all_m)
    return {"span_ms": span / 1e3,
            "busy_ms": sum(b - a for a, b in all_m) / 1e3,
            "nccl_ms": sum(b - a for a, b in n_m) / 1e3,
            "other_ms": sum(b - a for a, b in o_m) / 1e3,
            "nccl_overlapped_ms": inter / 1e3}


def _shares(lens, n, page, kvh, d, seed):
    """The pool's round-robin token share of each request on each of ``n``
    ranks, paged: per rank (k_pages, v_pages [n_pages, page, KVH, D] f32,
    table [B, max_pages], lengths [B]); page 0 stays empty.  Built on the
    CPU from ``seed`` so every rank builds the same shares."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = []
    for s in range(n):
        cnt = [len(range(s, ln, n)) for ln in lens]
        need = [-(-c // page) for c in cnt]
        table = np.zeros((len(lens), max(max(need), 1)), np.int32)
        start = 1
        for b, k in enumerate(need):
            table[b, :k] = np.arange(start, start + k)
            start += k
        shape = (start, page, kvh, d)
        out.append((torch.randn(shape, generator=g), torch.randn(shape, generator=g),
                    torch.as_tensor(table), torch.as_tensor(np.asarray(cnt, np.int32))))
    return out


def _tokens_check(tag, got, want, logits, want_logits, n_layers, log):
    """The mesh step's greedy tokens against one card's: the logits within
    n_layers x 2 x 2^-8 x max|logit| — over "model" each layer's two
    tensor-parallel products (attention out, FFN down) are summed from
    partial results rounded to bf16, one bf16 rounding each, where one card
    rounds the whole product once — and a token may differ only in a row
    whose one-card top two logits lie closer than twice the largest logit
    difference (a near tie the rounding may break either way).  Returns
    the counts."""
    import torch

    from repro_torch.launch import steps

    got, logits = steps.full_value(got).cpu(), steps.full_value(logits).float().cpu()
    want, want_logits = want.cpu(), want_logits.float().cpu()
    diff = (logits - want_logits).abs().max().item()
    tol = n_layers * 2 * 2.0 ** -8 * want_logits.abs().max().item()
    top2 = torch.topk(want_logits, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    differ = got != want
    ties = bool((margin[differ] <= 2 * diff).all())
    log.append(f"  {tag}: logits max abs diff {diff:.3e} (tol {tol:.3e}); "
               f"{int(differ.sum())} of {got.numel()} tokens differ (each a near tie: "
               f"{ties}; smallest top-2 margin {margin.min().item():.3e})")
    assert diff <= tol and ties, (tag, diff, tol, got, want, margin)
    return {"logit_diff": diff, "tol": tol, "differ": int(differ.sum()),
            "rows": got.numel()}


def _phase_model(rank, world, dev, cpu, res, log):
    """Phase 4: the mesh-aware steps and the recurrent layers' sequence
    parallelism across the world."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import init_params
    from repro_torch.core import ssm_sp, striped
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.transformer import layer_params

    world_group = dist.group.WORLD
    cfg = dataclasses.replace(get_config("lwm-7b"), n_layers=4)
    s, b_dec = 16384, 8
    if cpu:
        cfg, s = reduced(cfg, n_layers=2), 64
    gen = torch.Generator(device=dev).manual_seed(4)
    params = init_params(cfg, gen, dev)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (1, s))
    _, pre1 = steps.make_prefill_step(cfg, None, device=dev)
    _, dec1 = steps.make_decode_step(cfg, None, device=dev)
    # the decode batch's cache: B 8 at s cached tokens (seeded, the same on
    # every rank), one slot of padding
    shape = (cfg.n_layers, b_dec, s + world * 2, cfg.n_kv_heads, cfg.head_dim)
    gk = torch.Generator(device=dev).manual_seed(5)
    kc = (torch.randn(shape, generator=gk, device=dev) * 0.5).to(params["embed"].dtype)
    vc = (torch.randn(shape, generator=gk, device=dev) * 0.5).to(params["embed"].dtype)
    flat = {"k": kc, "v": vc,
            "length": torch.full((b_dec,), s, dtype=torch.int32, device=dev)}
    dtoks = torch.as_tensor(rng.integers(0, cfg.vocab_size, b_dec), dtype=torch.int32,
                            device=dev)
    dmodel1 = steps.build_model_for(cfg, None, "decode", device=dev)
    with torch.no_grad():
        want_dec_logits = dmodel1.decode(params, dtoks,
                                         steps.cache_from_flat(cfg, flat))[0]
    want_dec = dec1(dtoks, flat, params)["next_token"]
    res["decode_one_card_ms"] = _timed(lambda: dec1(dtoks, flat, params), world_group, dev)
    out = {}
    for shp in _model_meshes(world):
        tag = f"{shp[0]}x{shp[1]}"
        mesh = make_test_mesh(*shp, device=dev.type)
        perm = striped.stripe_indices(s, shp[0])
        toks = torch.as_tensor(prompt[:, perm], dtype=torch.int32, device=dev)
        pos = torch.as_tensor(perm, dtype=torch.int32, device=dev)
        want, _ = pre1({"tokens": toks}, pos, params)
        pmodel1 = steps.build_model_for(cfg, None, "prefill", device=dev)
        with torch.no_grad():
            want_logits = pmodel1.prefill(params, {"tokens": toks}, pos,
                                          last_logit_only=True)[0][:, -1]
        one_ms = _timed(lambda: pre1({"tokens": toks}, pos, params), world_group, dev)
        pmodel, pre = steps.make_prefill_step(cfg, mesh, device=dev)
        pp = steps.place_params(cfg, mesh, params)
        ish = steps.input_shardings(cfg, ShapeSpec("probe", "prefill", s, 1), mesh)
        batch = shlib.distribute({"tokens": toks}, mesh, ish["batch"])
        positions = shlib.distribute(pos, mesh, ish["positions"])
        ops.reset_dispatch_counts()
        nt, _ = pre(batch, positions, pp)
        counts, nbytes = dict(ops.dispatch_counts), dict(ops.comm_bytes)
        with torch.no_grad(), steps.mesh_context(mesh):
            logits = pmodel.prefill(pp, batch, positions, last_logit_only=True)[0][:, -1]
        pre_check = _tokens_check(f"{tag} prefill", nt, want, logits, want_logits,
                                  cfg.n_layers, log)
        ms = _timed(lambda: pre(batch, positions, pp), world_group, dev)
        dmodel, dec = steps.make_decode_step(cfg, mesh, device=dev)
        dsh = steps.input_shardings(cfg, ShapeSpec("probe", "decode", s, b_dec), mesh)
        dflat = shlib.distribute(flat, mesh, dsh["cache"])
        dt_ = shlib.distribute(dtoks, mesh, dsh["tokens"])
        ops.reset_dispatch_counts()
        got = dec(dt_, dflat, pp)["next_token"]
        dcounts, dbytes = dict(ops.dispatch_counts), dict(ops.comm_bytes)
        with torch.no_grad(), steps.mesh_context(mesh):
            dlogits = dmodel.decode(pp, dt_, steps.cache_from_flat(cfg, dflat))[0]
        dec_check = _tokens_check(f"{tag} decode", got, want_dec, dlogits,
                                  want_dec_logits, cfg.n_layers, log)
        dms = _timed(lambda: dec(dt_, dflat, pp), world_group, dev)
        out[tag] = dict(prefill_check=pre_check, decode_check=dec_check,
                        prefill_ms=ms, prefill_one_card_ms=one_ms,
                        prefill_counts=counts, prefill_comm_bytes=nbytes,
                        decode_ms=dms, decode_counts=dcounts, decode_comm_bytes=dbytes)
        log.append(f"  mesh {tag}: prefill S {s}: slowest rank {ms:.3f} ms vs one "
                   f"card {one_ms:.3f} ms; decode B {b_dec} at {s} cached: "
                   f"{dms:.3f} ms vs one card {res['decode_one_card_ms']:.3f} ms")
        del pp, dflat
    res["model_steps"] = out
    del flat, kc, vc, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the recurrent layers' sequence parallelism at full width
    mesh = make_test_mesh(world, 1, device=dev.type)
    b, s2 = 2, (64 if cpu else 8192)
    rec = {}
    for kind, arch, layers in (("mamba", "zamba2-2.7b", 6), ("mlstm", "xlstm-350m", 8)):
        c = dataclasses.replace(get_config(arch), n_layers=layers)
        if cpu:
            c = reduced(c)
        p = init_params(c, torch.Generator(device=dev).manual_seed(6), dev)
        if kind == "mamba":
            lp = layer_params(layer_params(p["layers"]["mamba_layers"], 0), 0)["mamba"]
            fn_sp, fn_one = ssm_sp.mamba2_forward_sp, ssm.mamba2_forward
        else:
            lp = layer_params(layer_params(p["layers"]["mlstm_layers"], 0), 0)["cell"]
            fn_sp, fn_one = ssm_sp.mlstm_forward_sp, xlstm.mlstm_block_forward
        gx = torch.Generator(device=dev).manual_seed(7)
        x = (torch.randn((b, s2, c.d_model), generator=gx, device=dev) * 0.1).to(
            p["embed"].dtype)
        with torch.no_grad():
            y1, _ = fn_one(lp, x, c, None)
            y, _ = fn_sp(mesh, "data", lp, x, c, None)
            yg = steps.full_value(y)
            err = (yg.float() - y1.float()).abs().max().item()
            tol = 3e-2 * y1.float().abs().max().item()
            assert err <= tol, (kind, err, tol)
            ops.reset_dispatch_counts()
            fn_sp(mesh, "data", lp, x, c, None)
            nbytes = dict(ops.comm_bytes)
            sp_ms = _timed(lambda: fn_sp(mesh, "data", lp, x, c, None), world_group, dev)
            one_ms = _timed(lambda: fn_one(lp, x, c, None), world_group, dev)
        rec[kind] = dict(sp_ms=sp_ms, one_card_ms=one_ms, max_abs_err=err, tol=tol,
                         comm_bytes=nbytes)
        log.append(f"  {kind}_forward_sp ({arch} width, B {b} x S {s2}, world {world}): "
                   f"max abs err {err:.3e} (tol {tol:.3e}) vs one card's forward; "
                   f"slowest rank {sp_ms:.3f} ms vs one card {one_ms:.3f} ms")
        del p, lp, x, y, y1, yg
    res["recurrent_sp"] = rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _ring_precision(world, dev, cpu, res, log)
    _f32_logits(world, dev, cpu, res, log)
    _moe_mesh(world, dev, cpu, res, log)
    del cs


def _model_meshes(world):
    return [(world, 1)] + ([(2, world // 2)] if world > 2 and world % 2 == 0 else [])


def _ring_precision(world, dev, cpu, res, log):
    """The ESP ring's merge precision: `ESPAttnImpl.prefill_attn` in bf16
    at lwm-7b width (B 1 x S 16384, striped) on rings of ``world`` ranks
    (world, 1) and of 2 ranks (2, world / 2), against one card's K4 over
    the whole sequence — its bf16 serving output and its f32 LSE-entry
    output — with the ring steps' partials as the port merges them (f32)
    and, as before, rounded to bf16 (the LSE entry's o rounded by this
    probe): max and mean abs error of each."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import striped
    from repro_torch.core.esp import ESPAttnImpl
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh

    cfg = get_config("lwm-7b")
    s = 16384
    if cpu:
        cfg, s = reduced(cfg), 64
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch.float32 if cpu else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((1, s, hh, d), generator=g, device=dev).to(dt)
               for hh in (h, kvh, kvh))
    lse_entry = ops.striped_flash_attention_lse

    def rounded(*a, **kw):  # the ring's partial before its o was f32
        o, lse = lse_entry(*a, **kw)
        return o.to(q.dtype).float(), lse

    out = {}
    for shp in _model_meshes(world):
        mesh = make_test_mesh(*shp, device=dev.type)
        perm = striped.stripe_indices(s, shp[0])
        pos = torch.as_tensor(perm, dtype=torch.int32, device=dev)
        qp, kp, vp = (x[:, perm] for x in (q, k, v))
        with torch.no_grad():
            one_bf16 = ops.attention(qp, kp, vp, pos, pos, causal=True).float()
            o, lse = lse_entry(qp, kp, vp, pos, pos, causal=True)
            one_f32 = torch.where(torch.isinf(lse.transpose(1, 2))[..., None],
                                  torch.zeros((), device=dev), o)
        impl = ESPAttnImpl(mesh, cfg)
        row = {}
        for arm in ("f32 partials", "bf16 partials"):
            ops.striped_flash_attention_lse = rounded if arm == "bf16 partials" else lse_entry
            try:
                with torch.no_grad(), steps.mesh_context(mesh):
                    ring = steps.full_value(impl.prefill_attn(
                        qp, kp, vp, pos, pos, causal=True, window=None,
                        softcap=None)).float()
            finally:
                ops.striped_flash_attention_lse = lse_entry
            row[arm] = {ref: {"max": (ring - want).abs().max().item(),
                              "mean": (ring - want).abs().mean().item()}
                        for ref, want in (("vs K4 bf16", one_bf16),
                                          ("vs K4 f32", one_f32))}
        tag = f"{shp[0]}x{shp[1]}"
        out[tag] = row
        log.append(f"  ring merge {tag} (ring of {shp[0]}, S {s}, bf16): "
                   + "; ".join(f"{arm}: " + ", ".join(
                       f"{ref} max {e['max']:.3e} mean {e['mean']:.3e}"
                       for ref, e in errs.items()) for arm, errs in row.items()))
    res["ring_precision"] = out


def _f32_logits(world, dev, cpu, res, log):
    """The (2, world / 2) logit check of phase 4 in f32: lwm-7b width, 4
    layers, prefill B 1 x S 16384 and decode B 8 at 16384 cached tokens,
    against one card's ``mesh=None`` steps; logits within 1e-4 x
    max|logit|, every token equal (in f32 the tensor-parallel sums move the
    logits by rounding only)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import init_params
    from repro_torch.core import striped
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh

    shp = _model_meshes(world)[-1]
    cfg = dataclasses.replace(get_config("lwm-7b"), n_layers=4, dtype="float32")
    s, b_dec = 16384, 8
    if cpu:
        cfg, s = reduced(cfg, n_layers=2), 64
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(9), dev)
    rng = np.random.default_rng(9)
    perm = striped.stripe_indices(s, shp[0])
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, s))[:, perm],
                           dtype=torch.int32, device=dev)
    pos = torch.as_tensor(perm, dtype=torch.int32, device=dev)
    mesh = make_test_mesh(*shp, device=dev.type)
    checks = {}
    with torch.no_grad():
        pmodel1 = steps.build_model_for(cfg, None, "prefill", device=dev)
        want = pmodel1.prefill(params, {"tokens": toks}, pos, last_logit_only=True)[0][:, -1]
        pmodel, _ = steps.make_prefill_step(cfg, mesh, device=dev)
        pp = steps.place_params(cfg, mesh, params)
        ish = steps.input_shardings(cfg, ShapeSpec("probe", "prefill", s, 1), mesh)
        batch = shlib.distribute({"tokens": toks}, mesh, ish["batch"])
        positions = shlib.distribute(pos, mesh, ish["positions"])
        with steps.mesh_context(mesh):
            got = pmodel.prefill(pp, batch, positions, last_logit_only=True)[0][:, -1]
        checks["prefill"] = (got, want)
        shape = (cfg.n_layers, b_dec, s + 2 * shp[0] * shp[1], cfg.n_kv_heads, cfg.head_dim)
        gk = torch.Generator(device=dev).manual_seed(10)
        flat = {"k": torch.randn(shape, generator=gk, device=dev) * 0.5,
                "v": torch.randn(shape, generator=gk, device=dev) * 0.5,
                "length": torch.full((b_dec,), s, dtype=torch.int32, device=dev)}
        dtoks = torch.as_tensor(rng.integers(0, cfg.vocab_size, b_dec), dtype=torch.int32,
                                device=dev)
        dmodel1 = steps.build_model_for(cfg, None, "decode", device=dev)
        want = dmodel1.decode(params, dtoks, steps.cache_from_flat(cfg, flat))[0]
        dmodel, _ = steps.make_decode_step(cfg, mesh, device=dev)
        dsh = steps.input_shardings(cfg, ShapeSpec("probe", "decode", s, b_dec), mesh)
        dflat = shlib.distribute(flat, mesh, dsh["cache"])
        with steps.mesh_context(mesh):
            got = dmodel.decode(pp, shlib.distribute(dtoks, mesh, dsh["tokens"]),
                                steps.cache_from_flat(cfg, dflat))[0]
        checks["decode"] = (got, want)
    out = {}
    for kind, (got, want) in checks.items():
        got = steps.full_value(got).float()
        diff = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        same = bool(torch.equal(torch.argmax(got, -1), torch.argmax(want, -1)))
        out[kind] = {"logit_diff": diff, "tol": tol, "tokens_equal": same}
        log.append(f"  f32 {shp[0]}x{shp[1]} {kind}: logits max abs diff {diff:.3e} "
                   f"(tol {tol:.3e}, max|logit| {want.abs().max().item():.3e}); tokens "
                   f"equal {same}")
        assert diff <= tol and same, (kind, diff, tol, same)
    res["f32_logits"] = out
    del params, pp, flat, dflat
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _moe_mesh(world, dev, cpu, res, log):
    """mixtral-8x7b at full width, 2 layers, f32, on (world, 1) and (2,
    world / 2): experts over "model" (expert-parallel wherever "model"
    divides the 8 experts) on real collectives.  The prefill step (B 1 x S
    8192, striped, the 4096-token window) and the decode step (B 8 over
    4096 cached tokens each) give tokens equal to one card's ``mesh=None`` steps,
    logits within 1e-4 x max|logit|, and layer 0's `apply_moe` drops the
    same fraction of assignments on the mesh (chip_smoke's check)."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import init_params
    from repro_torch.core import striped
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=2, dtype="float32")
    s, b_dec = 8192, 8
    if cpu:
        cfg, s = reduced(cfg, n_layers=2, sliding_window=16), 64
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(11), dev)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (1, s))
    s_dec = s // 2  # the decode batch's cached prompts: the window's length
    dprompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b_dec, s_dec)),
                              dtype=torch.int32, device=dev)
    dtoks = torch.as_tensor(rng.integers(0, cfg.vocab_size, b_dec), dtype=torch.int32,
                            device=dev)
    _, pre1 = steps.make_prefill_step(cfg, None, device=dev)
    _, dc = pre1({"tokens": dprompt}, torch.arange(s_dec, dtype=torch.int32, device=dev),
                 params)
    flat = {"k": dc.k, "v": dc.v,
            "length": torch.full((b_dec,), s_dec, dtype=torch.int32, device=dev)}
    pad = torch.zeros(dc.k.shape[:2] + (2 * world,) + dc.k.shape[3:], device=dev)
    flat["k"], flat["v"] = (torch.cat([x, pad], dim=2) for x in (flat["k"], flat["v"]))
    del dc
    dmodel1 = steps.build_model_for(cfg, None, "decode", device=dev)
    with torch.no_grad():
        want_dec = dmodel1.decode(params, dtoks, steps.cache_from_flat(cfg, flat))[0]
    out = {}
    for shp in _model_meshes(world):
        tag = f"{shp[0]}x{shp[1]}"
        mesh = make_test_mesh(*shp, device=dev.type)
        perm = striped.stripe_indices(s, shp[0])
        toks = torch.as_tensor(prompt[:, perm], dtype=torch.int32, device=dev)
        pos = torch.as_tensor(perm, dtype=torch.int32, device=dev)
        pmodel1 = steps.build_model_for(cfg, None, "prefill", device=dev)
        with torch.no_grad():
            want = pmodel1.prefill(params, {"tokens": toks}, pos, last_logit_only=True)[0][:, -1]
        pmodel, pre = steps.make_prefill_step(cfg, mesh, device=dev)
        pp = steps.place_params(cfg, mesh, params)
        ish = steps.input_shardings(cfg, ShapeSpec("probe", "prefill", s, 1), mesh)
        batch = shlib.distribute({"tokens": toks}, mesh, ish["batch"])
        positions = shlib.distribute(pos, mesh, ish["positions"])
        ops.reset_dispatch_counts()
        with torch.no_grad(), steps.mesh_context(mesh):
            got = pmodel.prefill(pp, batch, positions, last_logit_only=True)[0][:, -1]
        counts = dict(ops.dispatch_counts)
        dmodel, _ = steps.make_decode_step(cfg, mesh, device=dev)
        dsh = steps.input_shardings(cfg, ShapeSpec("probe", "decode", s_dec, b_dec), mesh)
        dflat = shlib.distribute(flat, mesh, dsh["cache"])
        with torch.no_grad(), steps.mesh_context(mesh):
            dgot = dmodel.decode(pp, shlib.distribute(dtoks, mesh, dsh["tokens"]),
                                 steps.cache_from_flat(cfg, dflat))[0]
        row = {"ep": cfg.n_experts % shp[1] == 0, "prefill_counts": counts}
        for kind, g_, w_ in (("prefill", got, want), ("decode", dgot, want_dec)):
            g_ = steps.full_value(g_).float()
            diff = (g_ - w_).abs().max().item()
            tol = 1e-4 * w_.abs().max().item()
            same = bool(torch.equal(torch.argmax(g_, -1), torch.argmax(w_, -1)))
            row[kind] = {"logit_diff": diff, "tol": tol, "tokens_equal": same}
            log.append(f"  mixtral (2 layers, f32) {tag} {kind}: logits max abs diff "
                       f"{diff:.3e} (tol {tol:.3e}); tokens equal {same}")
            assert diff <= tol and same, (tag, kind, diff, tol, same)
        moe_log = []
        cs._mesh_moe_dropped(cfg, params, pp, mesh, toks, moe_log)
        log.extend(moe_log)
        out[tag] = row
        del pp, dflat
    res["moe_mesh"] = out
    del params, flat
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _rank(rank, world, init, cpu, q_out, only=None):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
        from repro_torch.configs import get_config, reduced
        from repro_torch.convert import init_params
        from repro_torch.core import esp
        from repro_torch.engine.request import Request
        from repro_torch.engine.server import LoongServeEngine
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels.paged_flash_prefill import packed_flash_prefill_plain
        from repro_torch.launch.mesh import init_process_group, make_test_mesh
        from repro_torch.models import build_model

        dev = torch.device("cpu" if cpu else f"cuda:{rank}")
        if cpu:
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank)
            torch.backends.cuda.matmul.allow_tf32 = False
        backend = init_process_group(dev.type, init_method=init,
                                     world_size=world, rank=rank)
        mesh = make_test_mesh(world, 1, device=dev.type)
        group = mesh.get_group("data")
        cfg = get_config("lwm-7b")
        if cpu:
            cfg = reduced(cfg)
        h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        scale = 16 if cpu else 1
        lens = [int(x) // scale for x in
                np.random.default_rng(0).integers(512, 2049, 8)]
        res = {"rank": rank, "backend": backend, "world": world,
               "device": str(dev) if cpu else torch.cuda.get_device_name(dev)}
        log = []
        if only == 4:
            _phase_model(rank, world, dev, cpu, res, log)
            res["log"] = log
            res["tokens"] = []
            q_out.put((rank, res, None))
            return

        # ---- 1. the ring
        unit = 128 * world
        t = -(-sum(lens) // unit) * unit
        off = cs._offsets(lens, len(lens))
        g = torch.Generator().manual_seed(17)
        dt = torch.float32 if cpu else torch.bfloat16
        q, k, v = (torch.randn(t, hh, d, generator=g).to(dev, dt)
                   for hh in (h, kvh, kvh))
        want = packed_flash_prefill_plain(q, k, v, off)
        for db in (True, False):
            ops.reset_dispatch_counts()
            got = esp.ring_packed_prefill_spmd(mesh, q, k, v, off,
                                               double_buffer=db)
            counts, nbytes = dict(ops.dispatch_counts), dict(ops.comm_bytes)
            res[f"ring_err_db{int(db)}"] = cs._check(
                f"ring n {world} double_buffer {db}", got, want, log,
                v=None if cpu else v)
        res["ring_counts"], res["ring_bytes"] = counts, nbytes
        del want, got
        res["ring_ms_db1"] = _timed(lambda: esp.ring_packed_prefill_spmd(
            mesh, q, k, v, off, double_buffer=True), group, dev)
        res["ring_ms_db0"] = _timed(lambda: esp.ring_packed_prefill_spmd(
            mesh, q, k, v, off, double_buffer=False), group, dev)
        res["k1_one_card_ms"] = _timed(lambda: ops.prefill_packed(q, k, v, off),
                                       group, dev)
        if not cpu:
            for db in (True, False):
                call = (lambda db=db: esp.ring_packed_prefill_spmd(
                    mesh, q, k, v, off, double_buffer=db))
                if rank == 0:
                    res[f"ring_trace_db{int(db)}"] = _trace(call)
                else:
                    call()
        ks, vs = k[rank::world].contiguous(), v[rank::world].contiguous()
        res["ring_leg_ms"] = _timed(lambda: ops.ring_ppermute((ks, vs), group),
                                    group, dev)
        res["ring_leg_bytes"] = 2 * ks.numel() * ks.element_size()
        res["ring_tokens"] = t
        del q, k, v, ks, vs

        # ---- 2. the decode merges
        b = len(lens)
        shares = [tuple(x.to(dev) for x in s)
                  for s in _shares(lens, world, 16, kvh, d, 19)]
        g = torch.Generator().manual_seed(23)
        qd, kn, vn = (torch.randn(b, 1, hh, d, generator=g).to(dev)
                      for hh in (h, kvh, kvh))
        qpos = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
        views = [(kp, vp, bt, ln, None) for kp, vp, bt, ln in shares]
        kp, vp, bt, ln = shares[rank]
        want = ref.paged_decode_merge_ref(qd, kn, vn, views, query_pos=qpos)
        want_bs = ref.paged_decode_batch_sharded_ref(qd, kn, vn, views,
                                                     query_pos=qpos)
        b_l = b // world
        rows = slice(rank * b_l, (rank + 1) * b_l)
        for overlap in (True, False):
            got = esp.paged_decode_spmd(mesh, qd, kn, vn, qpos, kp, vp, bt, ln,
                                        overlap=overlap)
            res[f"spmd_err_ov{int(overlap)}"] = cs._check(
                f"paged_decode_spmd overlap {overlap}", got, want, log)
            got = esp.paged_decode_attn_sharded(
                group, world, qd[rows], kn[rows], vn[rows], qpos, kp, vp, bt,
                ln, overlap=overlap)
            res[f"sharded_err_ov{int(overlap)}"] = cs._check(
                f"paged_decode_attn_sharded overlap {overlap}", got,
                want_bs[rows], log)
        res["spmd_ms"] = _timed(lambda: esp.paged_decode_spmd(
            mesh, qd, kn, vn, qpos, kp, vp, bt, ln), group, dev)
        res["sharded_ms"] = _timed(lambda: esp.paged_decode_attn_sharded(
            group, world, qd[rows], kn[rows], vn[rows], qpos, kp, vp, bt, ln),
            group, dev)
        kw, vw, btw, lnw = cs._paged_layout(np.random.default_rng(3), lens, 16,
                                            1, kvh, d, dev)

        def whole():  # K2 + merge over the whole cache on one card
            p = ops.paged_decode_partial(qd, kw[0], vw[0], btw, lnw,
                                         query_pos=qpos)
            from repro_torch.models import attention as A

            return A.finalize_partial(A.merge_partial(
                A.partial_attention(qd, kn, vn, None), p))

        res["k2_one_card_ms"] = _timed(whole, group, dev)
        del shares, views, kw, vw

        # ---- 3. the engine
        cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
        params = _cpu_tree(init_params(cfg2, torch.Generator().manual_seed(1),
                                       "cpu"), dev)
        model = build_model(cfg2, device=dev)
        eng = LoongServeEngine(cfg2, world, 2048 // scale * 2, store_values=True,
                               model=model, params=params, mesh=mesh,
                               device=dev)
        rng = np.random.default_rng(1)
        lens2 = [int(x) // scale for x in rng.integers(128, 1025, 6)]
        reqs = [Request(input_len=n, max_new_tokens=8, arrival=0.0,
                        prompt=rng.integers(0, cfg2.vocab_size, n).tolist())
                for n in lens2]
        for r in reqs:
            eng.submit(r)
        ops.reset_dispatch_counts()
        dist.barrier()
        t0 = time.perf_counter()
        m = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res["engine_wall_s"] = time.perf_counter() - t0
        assert len(m.finished) == len(reqs)
        res["engine_counts"] = dict(ops.dispatch_counts)
        res["engine_bytes"] = dict(ops.comm_bytes)
        res["tokens"] = [list(r.output_tokens) for r in reqs]
        if rank == 0:
            for r in reqs:
                want_t = ref.serial_decode_oracle(model, params, r.prompt, 7)
                assert r.output_tokens == want_t, (r.rid, r.output_tokens, want_t)
            res["oracle"] = "equal"
        _phase_model(rank, world, dev, cpu, res, log)
        res["log"] = log
        q_out.put((rank, res, None))
    except BaseException:  # every failure goes to the parent
        q_out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="rehearse with N gloo ranks on the CPU")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--only", type=int, default=None, choices=[4],
                    help="run phase 4 (the mesh-aware model path) alone")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.cpu:
        world = args.cpu
    else:
        if not torch.cuda.is_available():
            print("mesh_probe: no CUDA device", file=sys.stderr)
            return 2
        world = torch.cuda.device_count()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    tmp = tempfile.mkdtemp(prefix="mesh_probe_")
    init = f"file://{os.path.join(tmp, 'rdv')}"
    ctx = mp.get_context("spawn")
    q_out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, init, bool(args.cpu), q_out,
                                             args.only))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        while len(results) + len(errors) < world:
            left = args.timeout - (time.perf_counter() - t0)
            if left <= 0:
                errors.append(f"timed out after {args.timeout:.0f} s")
                break
            try:
                rank, res, err = q_out.get(timeout=min(left, 5.0))
            except queue.Empty:
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    toks = [results[r]["tokens"] for r in range(world)]
    assert all(t == toks[0] for t in toks), "ranks disagree on the tokens"
    r0 = results[0]
    print(f"[mesh_probe] world {world} on {r0['backend']}, {r0['device']}")
    print("\n".join(r0["log"]))
    for key in ("ring_tokens", "ring_ms_db1", "ring_ms_db0", "ring_trace_db1",
                "ring_trace_db0", "k1_one_card_ms",
                "ring_leg_ms", "ring_leg_bytes", "ring_counts", "ring_bytes",
                "spmd_ms", "sharded_ms", "k2_one_card_ms", "engine_wall_s",
                "engine_counts", "engine_bytes", "oracle", "decode_one_card_ms",
                "model_steps", "recurrent_sp", "ring_precision", "f32_logits",
                "moe_mesh"):
        print(f"[mesh_probe] {key}: {r0.get(key)}")
    print(f"[mesh_probe] took {time.perf_counter() - t0:.1f} s")
    summary = {k: v for k, v in r0.items() if k not in ("log", "tokens")}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
