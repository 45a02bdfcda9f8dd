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
#: ``arch:variant`` is a reduced arch with `VARIANTS`' overrides
STEP_ARCHS = ["lwm-7b", "glm4-9b", "zamba2-2.7b", "xlstm-350m", "mixtral-8x7b",
              "arctic-480b", "pixtral-12b", "whisper-tiny", "mixtral-8x7b:drop",
              "mixtral-8x7b:e3"]
TRAIN_ARCHS = ["lwm-7b", "zamba2-2.7b", "xlstm-350m", "mixtral-8x7b",
               "pixtral-12b", "whisper-tiny", "mixtral-8x7b:e3"]
#: the archs whose steps are also held to the reference's own mesh-aware
#: steps on the (4, 2) `AxisType.Auto` mesh (they run there under jax 0.9)
MESH_REF_ARCHS = ["mixtral-8x7b", "arctic-480b", "pixtral-12b", "whisper-tiny",
                  "mixtral-8x7b:drop", "mixtral-8x7b:e3"]
#: moe variants: ``drop`` lowers the capacity factor until assignments
#: drop (`reduced` sets 4.0 so that smoke tests see none); ``e3`` has 3
#: experts, which the model axis (2) does not divide: TP inside each expert
VARIANTS = {"drop": dict(moe_capacity_factor=0.5), "e3": dict(n_experts=3)}
#: `apply_moe` alone on the mesh: (variant, constrain kind)
MOE_CASES = [("drop", "prefill"), ("drop", "train"), ("e3", "prefill"),
             ("e3", "train")]
B_MOE, S_MOE = 2, 32
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
    """The reduced config of ``arch`` (``name:variant``): 2 layers for the
    dense, moe and vlm families."""
    import importlib

    cfgs = importlib.import_module(f"{pkg}.configs")
    name, _, variant = arch.partition(":")
    cfg = cfgs.REGISTRY[name]
    over = dict(VARIANTS.get(variant, {}))
    if cfg.family in ("dense", "moe", "vlm"):
        over["n_layers"] = 2
    return cfgs.reduced(cfg, **over)


def step_layout(arch, n_data: int):
    """(permutation of the prompt's token axis, positions of the whole
    sequence) of a prefill step on
    ``n_data`` data ranks: striped for the attention families (the
    encoder-decoder's decoder included), contiguous for the recurrent ones
    (their layers run on the contiguous layout) and for vlm (a striped
    permutation cannot cross the image / text seam)."""
    from repro_torch.core import striped

    cfg = step_cfg(arch)
    if cfg.family in ("dense", "moe", "audio"):
        perm = striped.stripe_indices(S_STEP, n_data)
        return perm, perm.astype(np.int32)
    n_img = cfg.n_frontend_tokens if cfg.frontend == "patch_stub" else 0
    return np.arange(S_STEP - n_img), np.arange(S_STEP, dtype=np.int32)


def step_inputs(arch) -> dict:
    """Seeded numpy inputs of one step case: the prompt's tokens and its
    vlm / audio inputs (``extra``: a vlm prompt is ``n_frontend_tokens``
    image embeddings, then ``S_STEP - n_frontend_tokens`` text tokens), the
    decode batch's prompt (``dprompt``, ``dextra``), its ragged lengths and
    tokens."""
    cfg = step_cfg(arch, "repro_torch")
    rng = np.random.default_rng(11)
    n_img = cfg.n_frontend_tokens if cfg.frontend == "patch_stub" else 0

    def extra(b):
        out = {}
        if n_img:
            out["patch_embeds"] = (rng.normal(size=(b, n_img, cfg.d_model))
                                   * 0.05).astype(np.float32)
        if cfg.frontend == "audio_stub":
            out["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                             * 0.05).astype(np.float32)
        return out

    prompt = rng.integers(0, cfg.vocab_size, (B_STEP, S_STEP - n_img)).astype(np.int32)
    pre_extra = extra(B_STEP)
    dprompt = rng.integers(0, cfg.vocab_size, (B_DEC, S_STEP - n_img)).astype(np.int32)
    dec_extra = extra(B_DEC)
    length = rng.integers(S_STEP - 12, S_STEP + 1, B_DEC).astype(np.int32)
    dtokens = rng.integers(0, cfg.vocab_size, B_DEC).astype(np.int32)
    return dict(prompt=prompt, extra=pre_extra, dprompt=dprompt,
                dextra=dec_extra, length=length, dtokens=dtokens)


def moe_inputs(seed: int = 5) -> dict:
    """Per `VARIANTS` entry: x [B_MOE, S_MOE, d] (the layer input before
    its S-major flatten) and the cotangent weights w [B_MOE * S_MOE, d] of
    the train kind's ``sum(out * w) + aux``."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in VARIANTS:
        d = step_cfg(f"mixtral-8x7b:{v}").d_model
        out[v] = dict(x=rng.normal(size=(B_MOE, S_MOE, d)).astype(np.float32),
                      w=rng.normal(size=(B_MOE * S_MOE, d)).astype(np.float32))
    return out


# ------------------------------------------------------- the JAX reference
def jax_reference(in_path: str, out_path: str) -> None:
    """The reference's `ESPAttnImpl.prefill_attn` / `decode_attn`, its
    three `ssm_sp` functions and its mesh-aware steps of `MESH_REF_ARCHS`
    on a (4, 2) ("data", "model") mesh of 8 CPU devices (`AxisType.Auto`: the reference's own code runs unchanged under
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
        out["steps"] = {arch: _jax_mesh_steps(mesh, arch) for arch in MESH_REF_ARCHS}
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


def ref_decode_cache(arch, params, inp) -> dict:
    """The flat cache of a decode step case: the reference's ``mesh=None``
    prefill of the decode prompt, with the case's ragged lengths."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as jsteps

    cfg = step_cfg(arch, "repro")
    _, prefill = jsteps.make_prefill_step(cfg, None)
    batch = {k: jnp.asarray(v) for k, v in
             dict(inp["dextra"], tokens=inp["dprompt"]).items()}
    _, dc = jax.jit(prefill)(batch, jnp.arange(S_STEP), params)
    flat = {"length": inp["length"]}
    if dc.k is not None:
        flat["k"], flat["v"] = dc.k, dc.v
    if cfg.family == "hybrid":
        flat["ssm_h"], flat["ssm_conv"] = dc.ssm.h, dc.ssm.conv
    if cfg.family == "ssm":
        m, st = dc.ssm
        flat.update(xl_c=m.c, xl_n=m.n, xl_m=m.m, sl_c=st.c, sl_n=st.n, sl_h=st.h,
                    sl_m=st.m)
    if cfg.is_encoder_decoder:
        flat["cross_k"], flat["cross_v"] = dc.cross_k, dc.cross_v
    return {k: np.asarray(v) for k, v in flat.items()}


def _jax_mesh_steps(mesh, arch):
    """The reference's mesh-aware prefill (with its last-position logits)
    and decode steps of one step case on ``mesh`` ((4, 2) layout), on the
    parameters (``init(PRNGKey(0))``) and inputs the torch ranks get."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as jsteps

    cfg = step_cfg(arch, "repro")
    model, prefill = jsteps.make_prefill_step(cfg, mesh)
    params = model.init(jax.random.PRNGKey(0))
    inp = step_inputs(arch)
    dcache = ref_decode_cache(arch, params, inp)
    perm, pos = step_layout(arch, MESH8[0])
    batch = {k: jnp.asarray(v) for k, v in
             dict(inp["extra"], tokens=inp["prompt"][:, perm]).items()}
    nt, cache = jax.jit(prefill)(batch, jnp.asarray(pos), params)
    logits = jax.jit(lambda b, p, prm: model.prefill(prm, b, p, last_logit_only=True)[0])(
        batch, jnp.asarray(pos), params)
    _, decode = jsteps.make_decode_step(cfg, mesh)
    dout = jax.jit(decode)(jnp.asarray(inp["dtokens"]),
                           {k: jnp.asarray(v) for k, v in dcache.items()}, params)
    return dict(token=np.asarray(nt), logits=np.asarray(logits),
                cache={k: np.asarray(v) for k, v in cache._asdict().items()
                       if v is not None and not isinstance(v, tuple)},
                decode={k: np.asarray(v) for k, v in dout.items()})


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
        inp = c["inputs"]
        params = params_from_numpy(cfg, c["params"], device="cpu")
        pp = steps.place_params(cfg, mesh, params)
        perm, pos = step_layout(arch, mesh_shape[0])
        model, prefill = steps.make_prefill_step(cfg, mesh, device="cpu")
        ish = steps.input_shardings(cfg, ShapeSpec("t", "prefill", S_STEP, B_STEP), mesh)
        raw = dict(inp["extra"], tokens=inp["prompt"][:, perm])
        batch = shlib.distribute({k: _t(v) for k, v in raw.items()}, mesh, ish["batch"])
        positions = shlib.distribute(_t(pos), mesh, ish["positions"])
        ops.reset_dispatch_counts()
        nt, cache = prefill(batch, positions, pp)
        counts = dict(ops.dispatch_counts)
        with torch.no_grad(), implicit_replication():
            logits, _ = model.prefill(pp, batch, positions, last_logit_only=True)
        res = {"prefill_token": _full(nt), "prefill_logits": _full(logits),
               "prefill_cache": _tree_np(cache._asdict(), _full),
               "prefill_counts": counts}
        dmodel, decode = steps.make_decode_step(cfg, mesh, device="cpu")
        ish = steps.input_shardings(cfg, ShapeSpec("t", "decode", S_STEP, B_DEC), mesh)
        flat = {k: _t(v) for k, v in c["dcache"].items()}
        flat = shlib.distribute(flat, mesh, {k: ish["cache"][k] for k in flat})
        toks = shlib.distribute(_t(inp["dtokens"]), mesh, ish["tokens"])
        ops.reset_dispatch_counts()
        o = decode(toks, flat, pp)
        res["decode_counts"] = dict(ops.dispatch_counts)
        res["decode"] = {k: _full(v) for k, v in o.items()}
        res["decode_token_local"] = _local(o["next_token"].redistribute(
            mesh, shlib.placements(mesh, shlib.P(), 1)))
        train_model = steps.build_model_for(cfg, mesh, "train", esp=False, device="cpu")
        res["impls"] = {kind: type(m.attn_impl).__name__ for kind, m in
                        (("prefill", model), ("decode", dmodel), ("train", train_model))}
        out[arch] = res
    return out


def _moe(mesh_shape, payload):
    """`apply_moe` alone on the mesh for `MOE_CASES`: the layer input
    [B, S, d] placed as the layer's activation (``constrain(x, "act")``),
    flattened S-major, routed with the kind's constraints; its output, aux
    loss and dropped fraction, and the gradients of ``sum(out * w) + aux``
    in the train kind."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.models import moe

    mesh = _mesh(mesh_shape)
    out = {}
    for variant, kind in MOE_CASES:
        cfg = step_cfg(f"mixtral-8x7b:{variant}")
        c = payload["moe"][variant]
        p = params_from_numpy(cfg, c["params"], device="cpu")["layers"]["moe"]
        p = {k: v[0] for k, v in p.items()}  # layer 0
        specs = shlib.param_specs(cfg, mesh, {"moe": p}, train=kind == "train")["moe"]
        train = kind == "train"
        pd = {k: shlib.distribute(v, mesh, specs[k]).requires_grad_(train)
              for k, v in p.items()}
        constrain = shlib.make_constrain(cfg, mesh, kind)
        x0 = shlib.distribute(_t(c["x"]), mesh, shlib.P()).requires_grad_(train)
        with torch.enable_grad(), implicit_replication():
            flat = moe.tokens_s_major(constrain(x0, "act"))
            mo = moe.apply_moe(pd, flat, top_k=cfg.moe_top_k,
                               capacity_factor=cfg.moe_capacity_factor,
                               ffn_kind=cfg.ffn_kind, constrain=constrain)
            res = {"out": _full(mo.out), "aux": float(steps.full_value(mo.aux_loss)),
                   "dropped": float(mo.dropped_frac)}
            if train:
                loss = (mo.out * _t(c["w"])).sum() + mo.aux_loss
                grads = torch.autograd.grad(loss, [x0] + list(pd.values()))
                res["grads"] = {k: _full(g) for k, g in zip(["x"] + list(pd), grads)}
        out[(variant, kind)] = res
    return out


def case_steps8(rank, world, payload):
    return _steps(MESH8, payload, STEP_ARCHS)


def case_steps4(rank, world, payload):
    return _steps(MESH4, payload, STEP_ARCHS)


def case_moe8(rank, world, payload):
    return _moe(MESH8, payload)


def case_moe4(rank, world, payload):
    return _moe(MESH4, payload)


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
    "moe8": case_moe8,
    "moe4": case_moe4,
    "train4": case_train4,
}
