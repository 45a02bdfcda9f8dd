"""Multi-pod dry run: lay out every (arch x shape x mesh) cell and count it.

The PyTorch counterpart of `repro/launch/dryrun.py`.  The reference lowers
and compiles each cell's step for 512 host devices and reads XLA's memory
and cost analyses and its compiled HLO.  The port has no compiler to ask,
so for each cell the dry run:

  1. opens a fake world of 256 (or 512) ranks on PyTorch's fake process
     group and its (16, 16) or (2, 16, 16) `DeviceMesh`
     (`launch.mesh.fake_production_mesh`; this process is rank 0);
  2. builds the step of `launch.steps` (train with 8 microbatches,
     prefill with ESP, or decode) for that mesh, and the parameters,
     optimizer state and inputs as meta DTensors placed by the spec rules
     (`param_specs`, `opt_shardings`, `input_specs` / `input_shardings`):
     shapes only, no draws, no memory;
  3. runs the step once under the op census (`launch.census.Census`, the
     counterpart of `hlo.py`): rank 0's product FLOPs, bytes and
     collective traffic, the kernels (K4, its backward, K5) counted by
     shape;
  4. turns them into the roofline terms against one H100's data sheet
     (`manager.sib.HardwareSpec`: 989e12 bf16 FLOP/s, 3.35e12 B/s HBM) and
     the collective term against the card's inter-node link (NDR
     InfiniBand, 50e9 B/s each way: every "data" or "model" group of the
     production meshes spans more than one 8-card node), plus the
     useful-FLOPs ratio against `model_flops_estimate`.

It runs on meta wherever it is started and never touches a card, as the
reference runs on host devices.  The counts are rank 0's; with the batch
and sequence splits of the production meshes every rank's shapes are the
same, but a rank with a different ring position or expert slice may run
different masks, which shapes do not see.  The reference's
``set_dot_accum_f32`` (`repro/launch/dryrun.py:88`) has no counterpart:
its attention dots are kernels here, counted by shape.

Memory: ``argument_bytes`` and ``output_bytes`` are rank 0's exact local
shard bytes of the step's arguments (parameters, optimizer state, inputs)
and outputs; ``temp_bytes`` is the peak of the step's live meta tensors
(`torch.distributed._tools.mem_tracker.MemTracker`, the arguments
included) less the argument and output bytes: eager allocation, freed at
last use, with no compiler's buffer reuse and no rematerialization beyond
the step's own remat.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out results.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.manager.sib import HardwareSpec

# H100 SXM constants (per card): the data sheet's dense bf16 peak and HBM3
# rate, and the per-card inter-node link (see `HardwareSpec`)
_HW = HardwareSpec()
PEAK_FLOPS = _HW.peak_flops
HBM_BW = _HW.hbm_bw
NET_BW = _HW.net_bw
HBM_BYTES = _HW.hbm_bytes

_F32_KINDS = ("a_log", "dt_bias", "ones_f32", "zeros_f32", "forget_bias")


def meta_params(cfg) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` as meta tensors (``cfg.dtype``; the
    f32 leaves of `convert.init_params` in f32): shapes only."""
    from repro_torch.convert import param_shapes
    from repro_torch.models.transformer import torch_dtype

    dt = torch_dtype(cfg.dtype)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        shape, kind = spec
        return torch.empty(shape, device="meta",
                           dtype=torch.float32 if kind in _F32_KINDS else dt)

    return make(param_shapes(cfg))


def meta_like(specs) -> Any:
    """Meta tensors for a tree of `steps.TensorSpec` stand-ins."""
    from repro_torch.launch.steps import TensorSpec

    if isinstance(specs, dict):
        return {k: meta_like(v) for k, v in specs.items()}
    assert isinstance(specs, TensorSpec), specs
    return torch.empty(specs.shape, dtype=specs.dtype, device="meta")


def local_bytes(tree) -> int:
    """This rank's bytes of a tree of tensors / DTensors (local shards)."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor

    n = 0
    for x in pytree.tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


@contextlib.contextmanager
def _moe_c_over_data(on: Optional[bool]):
    from repro_torch.launch import sharding

    old = sharding.MOE_GROUP_C_OVER_DATA
    if on is not None:
        sharding.MOE_GROUP_C_OVER_DATA = bool(on)
    try:
        yield
    finally:
        sharding.MOE_GROUP_C_OVER_DATA = old


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    esp: bool = True,
    mesh=None,
    verbose: bool = True,
    options: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One cell's census.  options (the reference's hill-climb variants):
      ring_slice_tp: de-duplicated ring legs across tp (A2)
      kernel_adjusted: the census drops the bytes of the plain attention
        partials (``esp_partial_attention``, the decode's one-key partial);
        the kernels' own work is counted by shape either way (A1)
      ssm_chunk: override the recurrent chunk length (B)
      moe_capacity_factor: override MoE capacity (C)
      exclude_scope: census scopes whose bytes are dropped
      moe_c_over_data: `sharding.MOE_GROUP_C_OVER_DATA` for this cell (C1)
    """
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.census import COLLECTIVES, Census
    from repro_torch.launch.mesh import fake_production_mesh

    options = options or {}
    cfg = get_config(arch)
    for field in ("ssm_chunk", "moe_capacity_factor"):
        if field in options:
            cfg = dataclasses.replace(cfg, **{field: options[field]})
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "why": why}

    t0 = time.time()
    mesh = mesh or fake_production_mesh(multi_pod=multi_pod)
    sizes = shlib.axis_sizes(mesh)
    n_chips = int(np.prod(list(sizes.values())))
    res: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": dict(sizes),
        "chips": n_chips,
        "esp": esp,
        "options": dict(options),
    }
    try:
        with _moe_c_over_data(options.get("moe_c_over_data")):
            specs = steps_lib.input_specs(cfg, shape, mesh)
            shards = steps_lib.input_shardings(cfg, shape, mesh)
            train = shape.kind == "train"
            if train:
                # gradient accumulation: 8 microbatches, as the reference
                _, step = steps_lib.make_train_step(
                    cfg, mesh, microbatches=8, device="meta")
            elif shape.kind == "prefill":
                _, step = steps_lib.make_prefill_step(
                    cfg, mesh, esp=esp, device="meta",
                    esp_opts=({"ring_slice_tp": True}
                              if options.get("ring_slice_tp") else None))
            else:
                _, step = steps_lib.make_decode_step(cfg, mesh, esp=esp,
                                                     device="meta")
            params_shape = meta_params(cfg)
            params = shlib.distribute(
                params_shape, mesh,
                shlib.param_specs(cfg, mesh, params_shape, train=train))
            inputs = shlib.distribute(meta_like(specs), mesh, shards)
            if train:
                ospecs = steps_lib.opt_shardings(cfg, mesh, params_shape)
                opt = meta_like(steps_lib.opt_state_shapes(params_shape))
                opt = {"m": shlib.distribute(opt["m"], mesh, ospecs["m"]),
                       "v": shlib.distribute(opt["v"], mesh, ospecs["v"]),
                       "step": opt["step"]}
                args = (params, opt, inputs["batch"])
            elif shape.kind == "prefill":
                args = (inputs["batch"], inputs["positions"], params)
            else:
                args = (inputs["tokens"], inputs["cache"], params)
            arg_bytes = local_bytes(args)
            t_lower = time.time() - t0

            census = Census(exclude_scope=options.get(
                "exclude_scope",
                "esp_partial_attention" if options.get("kernel_adjusted")
                else None))
            mt = MemTracker()
            mt.track_external(*_leaves(args))
            with mt, census:
                out = step(*args)
            out_bytes = local_bytes(out)
            t_compile = time.time() - t0 - t_lower
        peak = mt.get_tracker_snapshot("peak")[torch.device("meta")]["Total"]
        temp = max(int(peak) - arg_bytes - out_bytes, 0)
        c = census.result()
        res["lower_s"] = round(t_lower, 2)  # building the step and its inputs
        res["compile_s"] = round(t_compile, 2)  # running it under the census
        res["memory"] = {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "peak_bytes": temp + arg_bytes + out_bytes,
        }
        res["hbm_model"] = estimate_hbm(cfg, shape, mesh, arg_bytes, out_bytes)
        # the reference's raw XLA numbers counted a loop body once; the
        # census runs every iteration, so the raw numbers are the census's
        res["cost_raw"] = {"flops": c["flops"], "bytes_accessed": c["bytes"]}
        res["collectives"] = {k: c[k] for k in COLLECTIVES}
        res["collectives"]["total_bytes"] = c["collective_bytes"]
        res["kernels"] = c["kernels"]
        flops, bytes_acc = c["flops"], c["bytes"]
        res["cost"] = {"flops": flops, "bytes_accessed": bytes_acc}

        # ---- roofline terms (seconds), per card ----
        comp_t = flops / PEAK_FLOPS
        mem_t = bytes_acc / HBM_BW
        coll_t = c["collective_bytes"] / NET_BW
        model_flops = model_flops_estimate(cfg, shape)
        res["roofline"] = {
            "compute_s": comp_t,
            "memory_s": mem_t,
            "collective_s": coll_t,
            "dominant": max(
                [("compute", comp_t), ("memory", mem_t), ("collective", coll_t)],
                key=lambda kv: kv[1],
            )[0],
            "model_flops_total": model_flops,
            "useful_flops_ratio": (
                model_flops / (flops * n_chips) if flops else None
            ),
        }
        res["status"] = "ok"
        if verbose:
            r = res["roofline"]
            print(
                f"[{arch} × {shape_name} × {n_chips}] OK "
                f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
                f"collective={r['collective_s']*1e3:.2f}ms dominant={r['dominant']} "
                f"peak_mem={res['memory']['peak_bytes']/2**30:.2f}GiB "
                f"useful={r['useful_flops_ratio'] and round(r['useful_flops_ratio'],3)}"
            )
            print("  memory_analysis:", res["memory"])
            print("  cost_analysis: flops=%.3e bytes=%.3e" % (flops, bytes_acc))
    except Exception as e:  # noqa: BLE001
        res["status"] = "error"
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{arch} × {shape_name}] FAIL: {res['error']}")
    return res


def _leaves(tree):
    import torch.utils._pytree as pytree

    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def estimate_hbm(cfg, shape, mesh, arg_bytes: int, out_bytes: int) -> Dict[str, float]:
    """HBM occupancy model, the reference's arithmetic against one H100's
    80 GB:
      resident  = per-card argument bytes (params + cache) + outputs
      transient = the largest per-layer working set actually live at once
    """
    from repro_torch.launch.sharding import axis_sizes

    sizes = axis_sizes(mesh)
    n_model = sizes.get("model", 1)
    n_data = sizes.get("data", 1)
    n_pod = sizes.get("pod", 1)
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    bl = max(b // (n_pod * n_data), 1)  # batch per device (batch-sharded dims)
    if shape.kind == "prefill":
        sl = max(s // n_data, 1)
        act = bl * sl * d * 2  # one [B_l, S_l, d] bf16 buffer
        score = bl * sl * min(sl, s) * max(cfg.n_heads // n_model, 1) * 4
        transient = 8 * act + score  # ~8 live activation buffers + scores
    elif shape.kind == "decode":
        s_kv = min(s, cfg.sliding_window or s)
        kv_slice = (s_kv // max(n_data * n_model, 1)) * cfg.n_kv_heads * cfg.head_dim * 4
        transient = 6 * bl * d * 2 + 3 * b * kv_slice  # few layers' kv slices
    else:  # train (8 microbatches, remat: per-layer carry + grads f32)
        mb = 8
        act = (bl // mb if bl >= mb else 1) * s * d * 2
        layer_carries = cfg.n_layers * act  # residual stream saved per layer
        transient = layer_carries + 10 * act
    return {
        "resident_bytes": float(arg_bytes + out_bytes),
        "transient_bytes": float(transient),
        "peak_bytes": float(arg_bytes + out_bytes + transient),
        "fits_hbm": bool(arg_bytes + out_bytes + transient < HBM_BYTES),
    }


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (+ attention) for serving."""
    n_active = cfg.param_count(active_only=True)
    d_tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    base = (6 if shape.kind == "train" else 2) * n_active * d_tokens
    # attention term
    n_attn = cfg.n_attention_applications
    hd = cfg.n_heads * cfg.head_dim
    if shape.kind == "decode":
        kv = shape.seq_len if not cfg.sliding_window else min(
            shape.seq_len, cfg.sliding_window
        )
        attn = 2 * 2 * n_attn * hd * kv * shape.global_batch
    elif cfg.family == "ssm":
        attn = 0
    else:
        w = cfg.sliding_window or shape.seq_len
        attn = 2 * 2 * n_attn * hd * shape.global_batch * (
            shape.seq_len * min(w, shape.seq_len) / 2
        )
        attn *= 3 if shape.kind == "train" else 1
    return float(base + attn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-esp", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED, SHAPES
    from repro_torch.launch.mesh import close_fake_world

    cells = []
    if args.all:
        for arch in ASSIGNED:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    by_cell: Dict[tuple, Dict[str, Any]] = {}
    try:
        # one fake world at a time: every cell of the single-pod world,
        # then every cell of the multi-pod one
        for mp in meshes:
            for arch, shape in cells:
                by_cell[(arch, shape, mp)] = run_cell(
                    arch, shape, multi_pod=mp, esp=not args.no_esp)
    finally:
        close_fake_world()
    # in the reference's order: each cell on each mesh
    results = [by_cell[(a, s, mp)] for a, s in cells for mp in meshes]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(
        f"cells: {len(results)}  ok: {sum(1 for r in results if r['status']=='ok')} "
        f"skipped: {sum(1 for r in results if r['status']=='skipped')}  errors: {n_err}"
    )
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
