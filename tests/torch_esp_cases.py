"""Rank bodies and the reference runner of `tests/test_torch_esp_spmd.py`:
the port's mesh-aware model path (`ESPAttnImpl`, `core.ssm_sp`, the mesh
steps) across spawned processes on gloo, and the JAX package's own SPMD
code on eight virtual CPU devices.

The rank bodies import only `repro_torch` (and torch / numpy): the spawned
ranks never load JAX or the reference package.  `jax_reference` runs in a
subprocess of its own (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
and imports JAX only there.  Every input is a seeded numpy array made in the
test process (`make_inputs`) and handed to both sides.

`spawn` is `torch_mesh_cases.spawn` (a ``file://`` rendezvous under the
test's tmp dir, a time limit per world) over this module's `CASES`.
"""
from __future__ import annotations

import numpy as np

import torch_mesh_cases

S_ATTN, D_ATTN = 64, 16  # prefill_attn operands
B_DEC, S_DEC = 8, 64  # decode_attn operands (B 8: multi-master on 4 ranks)
B_SSM, S_SSM = 2, 128  # the reference test's recurrent sizes
MESH8, MESH4 = (4, 2), (2, 2)
STEP_ARCHS = ["lwm-7b", "glm4-9b", "zamba2-2.7b", "xlstm-350m"]
TRAIN_ARCHS = ["lwm-7b", "zamba2-2.7b", "xlstm-350m"]
B_STEP, S_STEP = 2, 32  # prefill steps
B_TRAIN, T_TRAIN, MICRO = 4, 24, 2  # train steps: 2 microbatches of 2

# name: (B, H, KVH, force_batch_mode, ring_slice_tp, dop, window, softcap);
# the batch-mode slice-ring at B 3 keeps the batch whole on every tp rank
# (a true de-dup group), at B 2 it splits the batch over tp
PREFILL_CASES = {
    "heads": (2, 4, 2, False, False, None, None, None),
    "batch": (2, 4, 4, True, False, None, None, None),
    "slice_kv": (2, 4, 1, False, False, None, None, None),
    "ring_slice_tp": (2, 4, 1, False, True, None, None, None),
    "ring_slice_tp_batch": (3, 4, 2, True, True, None, None, None),
    "ring_slice_tp_batch_split": (2, 4, 2, True, True, None, None, None),
    "dop2": (2, 4, 4, False, False, 2, None, None),
    "window": (2, 4, 2, False, False, None, 20, None),
    "softcap": (2, 4, 2, False, False, None, None, 5.0),
}
#: cases where the reference's output is not attention (its batch-mode
#: slice-ring gathers the stripe slices of other batch rows): held to the
#: dense oracle only
REFERENCE_FAULTS = {"ring_slice_tp_batch_split"}
# name: (B, H, KVH, force_batch_mode, window, softcap); B 8 is multi-master
# on the 4 data ranks, B 2 single master; force_batch_mode selects mode 2
DECODE_CASES = {
    "multi_mode1": (8, 4, 2, False, None, None),
    "multi_mode2": (8, 4, 2, True, None, None),
    "single_mode1": (2, 4, 2, False, None, None),
    "single_mode2": (2, 4, 2, True, None, None),
    "window_mode1": (8, 4, 2, False, 24, None),
    "window_mode2": (8, 4, 2, True, 24, None),
    "softcap_mode2": (8, 4, 2, True, None, 5.0),
}
SSM_KINDS = ["mamba", "mlstm", "slstm"]


def spawn(world, cases, payload, tmp, timeout=300.0):
    return torch_mesh_cases.spawn(world, cases, payload, tmp, timeout,
                                  module=__name__)


# ------------------------------------------------------------------ inputs
def prefill_positions(name: str) -> np.ndarray:
    """Striped positions over the 4 data ranks; ``dop2``: two DoP-2 groups,
    each holding half the sequence as an independent request (the layout
    of the reference's ``test_esp_dop_subgroups``)."""
    from repro_torch.core import striped

    if name == "dop2":
        half = S_ATTN // 2
        return np.concatenate([striped.stripe_indices(half, 2)] * 2).astype(np.int32)
    return striped.stripe_indices(S_ATTN, MESH8[0]).astype(np.int32)


def make_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    prefill = {}
    for name, (b, h, kvh, *_rest) in PREFILL_CASES.items():
        prefill[name] = dict(
            q=normal(b, S_ATTN, h, D_ATTN), k=normal(b, S_ATTN, kvh, D_ATTN),
            v=normal(b, S_ATTN, kvh, D_ATTN), pos=prefill_positions(name))
    decode = {}
    for name, (b, h, kvh, *_rest) in DECODE_CASES.items():
        decode[name] = dict(
            q=normal(b, 1, h, D_ATTN), kc=normal(b, S_DEC, kvh, D_ATTN),
            vc=normal(b, S_DEC, kvh, D_ATTN), kn=normal(b, 1, kvh, D_ATTN),
            vn=normal(b, 1, kvh, D_ATTN),
            cl=rng.integers(1, S_DEC + 1, b).astype(np.int32))
    return {"prefill": prefill, "decode": decode}


def attn_cfg(h, kvh, pkg="repro_torch"):
    import importlib

    cfgs = importlib.import_module(f"{pkg}.configs")
    return cfgs.reduced(cfgs.REGISTRY["lwm-7b"], n_heads=h, n_kv_heads=kvh,
                        d_head=D_ATTN)


def ssm_cfg(kind, pkg="repro_torch"):
    import importlib

    cfgs = importlib.import_module(f"{pkg}.configs")
    arch = "zamba2-2.7b" if kind == "mamba" else "xlstm-350m"
    return cfgs.reduced(cfgs.REGISTRY[arch])


def step_cfg(arch, pkg="repro_torch"):
    import importlib

    cfgs = importlib.import_module(f"{pkg}.configs")
    cfg = cfgs.REGISTRY[arch]
    return cfgs.reduced(cfg, n_layers=2) if cfg.family == "dense" else cfgs.reduced(cfg)


def step_layout(arch, n_data: int):
    """(permutation of the prompt axis, positions) of a prefill step on
    ``n_data`` data ranks: striped for the attention families, contiguous
    for the recurrent ones (their layers run on the contiguous layout)."""
    from repro_torch.core import striped

    if step_cfg(arch).family == "dense":
        perm = striped.stripe_indices(S_STEP, n_data)
    else:
        perm = np.arange(S_STEP)
    return perm, perm.astype(np.int32)


# ------------------------------------------------------- the JAX reference
def jax_reference(in_path: str, out_path: str) -> None:
    """The reference's `ESPAttnImpl.prefill_attn` / `decode_attn` and its
    three `ssm_sp` functions on a (4, 2) ("data", "model") mesh of 8 CPU
    devices (`AxisType.Auto`: the reference's own code runs unchanged under
    jax 0.9 on such a mesh); outputs go through `np.asarray` before any
    indexing.  Run in a subprocess with the 8-device XLA flag."""
    import pickle

    import jax

    from repro.core import ssm_sp
    from repro.core.esp import ESPAttnImpl

    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    mesh = jax.make_mesh(MESH8, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {"prefill": {}, "decode": {}, "ssm": {}}
    with mesh:
        for name, (_b, h, kvh, fb, rs, dop, window, softcap) in PREFILL_CASES.items():
            impl = ESPAttnImpl(mesh, attn_cfg(h, kvh, "repro"), dop=dop,
                               force_batch_mode=fb, ring_slice_tp=rs)
            c = inp["prefill"][name]
            fn = jax.jit(lambda q, k, v, p, impl=impl, window=window, softcap=softcap:
                         impl.prefill_attn(q, k, v, p, p, causal=True,
                                           window=window, softcap=softcap))
            out["prefill"][name] = np.asarray(fn(c["q"], c["k"], c["v"], c["pos"]))
        for name, (b, h, kvh, fb, window, softcap) in DECODE_CASES.items():
            impl = ESPAttnImpl(mesh, attn_cfg(h, kvh, "repro"), force_batch_mode=fb)
            c = inp["decode"][name]
            fn = jax.jit(lambda *a, impl=impl, window=window, softcap=softcap:
                         impl.decode_attn(*a, window=window, softcap=softcap))
            out["decode"][name] = np.asarray(
                fn(c["q"], c["kc"], c["vc"], c["kn"], c["vn"], c["cl"]))
        fns = {"mamba": ssm_sp.mamba2_forward_sp, "mlstm": ssm_sp.mlstm_forward_sp,
               "slstm": ssm_sp.slstm_forward_sp}
        for kind in SSM_KINDS:
            c = inp["ssm"][kind]
            cfg = ssm_cfg(kind, "repro")
            fn = jax.jit(lambda x, p, f=fns[kind], cfg=cfg:
                         f(mesh, "data", p, x, cfg, None, tp="model"))
            y, st = fn(c["x"], c["p"])
            out["ssm"][kind] = (np.asarray(y), [np.asarray(a) for a in st])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------- rank bodies
def _t(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def _full(x):
    from torch.distributed.tensor import DTensor

    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().float().numpy()


def _local(x):
    from torch.distributed.tensor import DTensor

    x = x.to_local() if isinstance(x, DTensor) else x
    return x.detach().float().numpy()


def _mesh(shape):
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(*shape, device="cpu")


def _tree_np(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_np(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return [_tree_np(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def case_attn(rank, world, payload):
    """`ESPAttnImpl.prefill_attn` and `decode_attn` on the (4, 2) mesh, and
    the block order of a dim split over ("data", "model")."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.esp import ESPAttnImpl
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shlib

    mesh = _mesh(MESH8)
    out = {"prefill": {}, "decode": {}, "counts": {}}
    for name, (_b, h, kvh, fb, rs, dop, window, softcap) in PREFILL_CASES.items():
        impl = ESPAttnImpl(mesh, attn_cfg(h, kvh), dop=dop, force_batch_mode=fb,
                           ring_slice_tp=rs)
        c = payload["prefill"][name]
        ops.reset_dispatch_counts()
        with torch.no_grad(), implicit_replication():
            o = impl.prefill_attn(_t(c["q"]), _t(c["k"]), _t(c["v"]), _t(c["pos"]),
                                  _t(c["pos"]), causal=True, window=window,
                                  softcap=softcap)
        out["counts"][name] = dict(ops.dispatch_counts)
        out["prefill"][name] = _full(o)
    for name, (b, h, kvh, fb, window, softcap) in DECODE_CASES.items():
        impl = ESPAttnImpl(mesh, attn_cfg(h, kvh), force_batch_mode=fb)
        c = payload["decode"][name]
        ops.reset_dispatch_counts()
        with torch.no_grad(), implicit_replication():
            o = impl.decode_attn(*(_t(c[k]) for k in ("q", "kc", "vc", "kn", "vn", "cl")),
                                 window=window, softcap=softcap)
        out["counts"]["decode_" + name] = dict(ops.dispatch_counts)
        out["decode"][name] = _full(o)
    blocks = shlib.distribute(torch.arange(16), mesh, shlib.P(("data", "model")))
    out["order"] = (int(mesh.get_local_rank("data")), int(mesh.get_local_rank("model")),
                    blocks.to_local().numpy())
    return out


def case_ssm(rank, world, payload):
    """The three `ssm_sp` functions on the (4, 2) mesh (the state is
    replicated over "data": each rank's local copy is returned too)."""
    import torch

    from repro_torch.core import ssm_sp

    mesh = _mesh(MESH8)
    fns = {"mamba": ssm_sp.mamba2_forward_sp, "mlstm": ssm_sp.mlstm_forward_sp,
           "slstm": ssm_sp.slstm_forward_sp}
    out = {}
    for kind in SSM_KINDS:
        c = payload["ssm"][kind]
        p = {k: _t(v) for k, v in c["p"].items()}
        with torch.no_grad():
            y, st = fns[kind](mesh, "data", p, _t(c["x"]), ssm_cfg(kind), None,
                              tp="model")
        out[kind] = (_full(y), [_full(a) for a in st], [_local(a) for a in st])
    return out


def _steps(mesh_shape, payload, archs):
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps

    mesh = _mesh(mesh_shape)
    out = {}
    for arch in archs:
        cfg = step_cfg(arch)
        c = payload["steps"][arch]
        params = params_from_numpy(cfg, c["params"], device="cpu")
        pp = steps.place_params(cfg, mesh, params)
        perm, pos = step_layout(arch, mesh_shape[0])
        model, prefill = steps.make_prefill_step(cfg, mesh, device="cpu")
        ish = steps.input_shardings(cfg, ShapeSpec("t", "prefill", S_STEP, B_STEP), mesh)
        batch = shlib.distribute({"tokens": _t(c["prompt"][:, perm])}, mesh, ish["batch"])
        positions = shlib.distribute(_t(pos), mesh, ish["positions"])
        ops.reset_dispatch_counts()
        nt, cache = prefill(batch, positions, pp)
        counts = dict(ops.dispatch_counts)
        with torch.no_grad(), implicit_replication():
            logits, _ = model.prefill(pp, batch, positions, last_logit_only=True)
        res = {"prefill_token": _full(nt), "prefill_logits": _full(logits),
               "prefill_cache": _tree_np(cache._asdict(), _full),
               "prefill_counts": counts}
        _, decode = steps.make_decode_step(cfg, mesh, device="cpu")
        ish = steps.input_shardings(cfg, ShapeSpec("t", "decode", S_STEP, B_DEC), mesh)
        flat = {k: _t(v) for k, v in c["dcache"].items()}
        flat = shlib.distribute(flat, mesh, {k: ish["cache"][k] for k in flat})
        toks = shlib.distribute(_t(c["dtokens"]), mesh, ish["tokens"])
        ops.reset_dispatch_counts()
        o = decode(toks, flat, pp)
        res["decode_counts"] = dict(ops.dispatch_counts)
        res["decode"] = {k: _full(v) for k, v in o.items()}
        res["decode_token_local"] = _local(o["next_token"].redistribute(
            mesh, shlib.placements(mesh, shlib.P(), 1)))
        out[arch] = res
    return out


def case_steps8(rank, world, payload):
    return _steps(MESH8, payload, STEP_ARCHS)


def case_steps4(rank, world, payload):
    return _steps(MESH4, payload, STEP_ARCHS)


def case_train4(rank, world, payload):
    """Two ZeRO-1 train steps (2 microbatches) on the (2, 2) mesh: per step
    the metrics, the full parameters and moments, and this rank's local
    moment shards."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import opt_state_from_numpy, params_from_numpy
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps

    mesh = _mesh(MESH4)
    out = {"coords": (int(mesh.get_local_rank("data")),
                      int(mesh.get_local_rank("model")))}
    for arch in TRAIN_ARCHS:
        cfg = step_cfg(arch)
        c = payload["train"][arch]
        params = steps.place_params(
            cfg, mesh, params_from_numpy(cfg, c["params"], device="cpu"), train=True)
        opt = steps.place_opt_state(cfg, mesh, opt_state_from_numpy(cfg, c["opt"], "cpu"))
        ish = steps.input_shardings(cfg, ShapeSpec("t", "train", T_TRAIN, B_TRAIN), mesh)
        batch = shlib.distribute({k: _t(v) for k, v in c["batch"].items()}, mesh,
                                 ish["batch"])
        _, step = steps.make_train_step(cfg, mesh, loss_chunk=16, microbatches=MICRO,
                                        device="cpu")
        res = []
        for _ in range(2):
            params, opt, met = step(params, opt, batch)
            res.append({
                "metrics": {k: float(v) for k, v in met.items()},
                "params": _tree_np(params, _full),
                "m": _tree_np(opt["m"], _full), "v": _tree_np(opt["v"], _full),
                "m_local": _tree_np(opt["m"], _local),
                "step": int(opt["step"]),
            })
        out[arch] = res
    return out


CASES = {
    "attn": case_attn,
    "ssm": case_ssm,
    "steps8": case_steps8,
    "steps4": case_steps4,
    "train4": case_train4,
}
