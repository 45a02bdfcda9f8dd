"""The port's mesh-aware model path on `torch.distributed` (gloo, CPU), held
to the JAX package.

  (a) the spec rules (`launch.sharding.param_specs`, `steps.zero1_specs` /
      `opt_shardings`, `input_specs` / `input_shardings`) against the
      reference's on a device-free `jax.sharding.AbstractMesh`: every
      registered arch at full size, meshes (4, 2), (16, 16) and
      (2, 16, 16), leaf by leaf;
  (b) `ESPAttnImpl.prefill_attn` on a (4, 2) world of 8 ranks (heads mode,
      batch mode, KV heads sliced per rank, the A2 slice-ring, DoP-2
      sub-rings, a window, a softcap) against the reference's
      `ESPAttnImpl` (run once in a subprocess on 8 virtual devices) and
      the dense `full_attention`, 2e-5;
  (c) `ESPAttnImpl.decode_attn` (multi-master / single master, mode 1 /
      mode 2, window, softcap) likewise, 2e-5;
  (d) `core.ssm_sp`'s three functions at B 2, S 128 against the
      reference's `_sp` functions and its single-device forwards, 1e-4;
  (e) the mesh-aware prefill / decode steps on (4, 2) and (2, 2) for
      reduced lwm-7b, glm4-9b, zamba2-2.7b, xlstm-350m, mixtral-8x7b,
      arctic-480b, pixtral-12b and whisper-tiny (next tokens
      equal the reference's ``mesh=None`` step's; logits and cache within
      1e-4), and two ZeRO-1 train steps with 2 microbatches on (2, 2) (the
      loss within 1e-5 relative, parameters within PR 18's AdamW rule, each
      rank's local moment shard equal to its block of the reference's
      moments); the moe (mixtral, arctic, a capacity-bound and a 3-expert
      variant), vlm (pixtral) and audio (whisper) steps likewise, and held
      to the reference's own mesh-aware steps on its (4, 2) Auto mesh;
      `apply_moe` alone on the mesh against the reference's global
      routing (dropped fraction, aux loss, output, gradients);
  (f) every replicated output is identical on every rank.

The torch ranks are spawned by `tests/torch_esp_cases.py` — one world of 8
ranks and one of 4 — and import only `repro_torch`.
"""
import concurrent.futures
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_esp_cases as C  # noqa: E402
import torch_train_cases as TC  # noqa: E402
from repro.configs import REGISTRY, SHAPES, shape_applicable  # noqa: E402
from repro.launch import sharding as jshard  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.convert import param_shapes  # noqa: E402
from repro_torch.launch import sharding as tshard  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402

ROOT = pathlib.Path(__file__).parent.parent
ATTN_TOL = 2e-5
SSM_TOL = 1e-4
STEP_TOL = 1e-4
LOSS_RTOL = 1e-5
SPEC_MESHES = [((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]
MESH_ONLY_LATER = ["mixtral-8x7b", "arctic-480b", "pixtral-12b", "whisper-tiny"]


# ====================================================================== (a)
def _norm(spec, ndim):
    """A spec as a tuple of ndim entries; a one-axis tuple is its name."""
    ent = list(spec) + [None] * (ndim - len(spec))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, tuple) else e) for e in ent)


def _jflat(tree, leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): v
            for path, v in flat}


def _tflat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tflat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


_SHAPES_CACHE = {}


def _jparams_shape(arch):
    if arch not in _SHAPES_CACHE:
        model = j_build_model(REGISTRY[arch])
        _SHAPES_CACHE[arch] = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return _SHAPES_CACHE[arch]


def _is_jspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _hold_specs(jtree, ttree, shapes, what):
    jf = _jflat(jtree, _is_jspec)
    tf = _tflat(ttree)
    assert set(jf) == set(tf), (what, sorted(set(jf) ^ set(tf)))
    for key, js in jf.items():
        nd = len(shapes[key])
        assert _norm(tf[key], nd) == _norm(js, nd), (what, key, tf[key], js)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
@pytest.mark.parametrize("mesh_shape,axes", SPEC_MESHES,
                         ids=["4x2", "16x16", "2x16x16"])
def test_specs_match_reference(arch, mesh_shape, axes):
    jcfg, tcfg = REGISTRY[arch], T_REGISTRY[arch]
    jmesh = jax.sharding.AbstractMesh(mesh_shape, axes)
    tmesh = MeshShape(mesh_shape, axes)
    jshape = _jparams_shape(arch)
    tshape = param_shapes(tcfg)
    shapes = {k: tuple(v.shape) for k, v in _jflat(jshape).items()}
    assert shapes == {k: tuple(v[0]) for k, v in _tflat(tshape).items()}
    for train in (False, True):
        _hold_specs(jshard.param_specs(jcfg, jmesh, jshape, train=train),
                    tshard.param_specs(tcfg, tmesh, tshape, train=train),
                    shapes, f"param_specs train={train}")
    jz = jsteps.zero1_specs(jshard.param_specs(jcfg, jmesh, jshape, train=True),
                            jshape, jmesh)
    tz = tsteps.zero1_specs(tshard.param_specs(tcfg, tmesh, tshape, train=True),
                            tshape, tmesh)
    _hold_specs(jz, tz, shapes, "zero1_specs")
    jo = jax.tree.map(lambda s: s.spec, jsteps.opt_shardings(jcfg, jmesh, jshape),
                      is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    to = tsteps.opt_shardings(tcfg, tmesh, tshape)
    for part in ("m", "v"):
        _hold_specs(jo[part], to[part], shapes, f"opt_shardings {part}")
    assert _norm(to["step"], 0) == _norm(jo["step"], 0)
    ost = tsteps.opt_state_shapes(tshape)
    assert {k: v.shape for k, v in _tflat(ost["m"]).items()} == shapes
    assert ost["step"].shape == () and ost["step"].dtype == torch.int32
    n_shapes = 0
    for name, shape in SHAPES.items():
        if not shape_applicable(jcfg, shape)[0]:
            continue
        n_shapes += 1
        js, ts = jsteps.input_specs(jcfg, shape, jmesh), tsteps.input_specs(tcfg, shape, tmesh)
        jf, tf = _jflat(js), _tflat(ts)
        assert set(jf) == set(tf), (name, sorted(set(jf) ^ set(tf)))
        for key, sds in jf.items():
            assert tf[key].shape == tuple(sds.shape), (name, key)
            assert str(tf[key].dtype).replace("torch.", "") == str(sds.dtype), (name, key)
        jsh = jax.tree.map(lambda s: s.spec, jsteps.input_shardings(jcfg, shape, jmesh),
                           is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        tsh = tsteps.input_shardings(tcfg, shape, tmesh)
        jshf, tshf = _jflat(jsh, _is_jspec), _tflat(tsh)
        assert set(jshf) == set(tshf) == set(jf), name
        for key, spec in jshf.items():
            nd = len(jf[key].shape)
            assert _norm(tshf[key], nd) == _norm(spec, nd), (name, key, tshf[key], spec)
    assert n_shapes >= 3


@pytest.mark.parametrize("arch", MESH_ONLY_LATER)
def test_mesh_later_families_raise(worlds, arch):
    """moe, vlm and audio models on a mesh — which raised until ROADMAP
    item 14.1b was ported — now build and run on both worlds: prefill and
    decode through `ESPAttnImpl`, train through `ShardedAttnImpl`, next
    tokens equal to the reference's ``mesh=None`` steps'; and nothing in
    the port names the item any more."""
    for world, n_data in (("8", C.MESH8[0]), ("4", C.MESH4[0])):
        for res in worlds["w" + world]:
            got = res["steps" + world][arch]
            assert got["impls"] == {"prefill": "ESPAttnImpl", "decode": "ESPAttnImpl",
                                    "train": "ShardedAttnImpl"}
            np.testing.assert_array_equal(got["prefill_token"],
                                          worlds["steps"][arch][n_data]["token"])
            np.testing.assert_array_equal(got["decode"]["next_token"],
                                          worlds["steps"][arch]["decode"]["next_token"])
    assert not any("14.1b" in f.read_text()
                   for f in (ROOT / "src" / "repro_torch").rglob("*.py"))


# ============================================ ops.attention_partial (K4)
# (B, Sq, H, KVH, D, q shard, KV shard of 4, window, softcap): a ring step
# of striped shards — q shard 0 against KV shard 1 has rows with no key
PARTIAL_CASES = {
    "striped_empty_rows": (2, 24, 4, 2, 16, 0, 1, None, None),
    "striped_window_gqa": (1, 32, 4, 1, 16, 3, 1, 9, None),
    "softcap": (2, 16, 4, 4, 16, 2, 2, None, 5.0),
}


@pytest.mark.parametrize("name", list(PARTIAL_CASES))
def test_attention_partial_matches_reference(name):
    """`ops.attention_partial` (K4's plain version with its LSE on the CPU,
    through the same conversion as the kernel's output) against the
    reference's ``partial_attention`` under ``mask_from_positions``: the
    same partial up to its representation — (o, m = lse, l = 1) against
    (o, m, l) — so the finalized outputs and ``m + log l`` agree, 2e-5, and
    an empty row is ``m = -inf, l = 0`` in both."""
    from repro_torch.kernels import ops

    b, sq, h, kvh, d, r, c, window, softcap = PARTIAL_CASES[name]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sq, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sq, kvh, d)).astype(np.float32)
    qp = (np.arange(sq) * 4 + r).astype(np.int32)
    kp = (np.arange(sq) * 4 + c).astype(np.int32)
    want = JA.partial_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        JA.mask_from_positions(jnp.asarray(qp), jnp.asarray(kp), causal=True,
                               window=window), softcap=softcap)
    got = ops.attention_partial(*(torch.from_numpy(x) for x in (q, k, v, qp, kp)),
                                causal=True, window=window, softcap=softcap)
    wo, wm, wl = (np.asarray(x) for x in want)
    go, gm, gl = (x.numpy() for x in got)
    empty = wl == 0
    if name == "striped_empty_rows":
        assert empty.any()
    np.testing.assert_array_equal(np.isinf(gm), empty)
    np.testing.assert_array_equal(gl[empty], 0.0)
    fin = lambda o, l: o / np.where(l == 0, 1.0, l)[..., None]  # noqa: E731
    np.testing.assert_allclose(fin(go, gl), fin(wo, wl), rtol=0, atol=ATTN_TOL)
    np.testing.assert_allclose(gm[~empty], (wm + np.log(np.where(empty, 1.0, wl)))[~empty],
                               rtol=0, atol=ATTN_TOL)
    q_t = torch.from_numpy(q).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention_partial(q_t, *(torch.from_numpy(x) for x in (k, v, qp, kp)))


def test_attention_partial_is_f32_for_bf16():
    """The ring step's partial keeps K4's normalized accumulator in f32 for
    bf16 operands (the reference merges f32 partials): on the CPU the plain
    version's o is the f32 attention of the bf16 values, never rounded to
    bf16; the serving / training entry keeps the operands' dtype."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import striped_attention as tsa

    b, sq, h, kvh, d, r, c, window, softcap = PARTIAL_CASES["striped_window_gqa"]
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=shp).astype(np.float32)).to(torch.bfloat16)
               for shp in ((b, sq, h, d), (b, sq, kvh, d), (b, sq, kvh, d)))
    qp = torch.from_numpy((np.arange(sq) * 4 + r).astype(np.int32))
    kp = torch.from_numpy((np.arange(sq) * 4 + c).astype(np.int32))
    kw = dict(causal=True, window=window, softcap=softcap)
    part = ops.attention_partial(q, k, v, qp, kp, **kw)
    assert part.o.dtype == part.m.dtype == part.l.dtype == torch.float32
    want = tsa.striped_flash_attention(q.float(), k.float(), v.float(), qp, kp, **kw)
    fin = part.o / torch.where(part.l == 0, 1.0, part.l)[..., None]
    np.testing.assert_allclose(fin.numpy(), want.numpy(), rtol=0, atol=ATTN_TOL)
    assert not torch.equal(fin, fin.to(torch.bfloat16).float())  # not rounded
    assert tsa.striped_flash_attention(q, k, v, qp, kp, **kw).dtype == torch.bfloat16


# ============================================================== the worlds
def _ssm_inputs():
    key = jax.random.PRNGKey(0)
    out = {}
    cfg = C.ssm_cfg("mamba", "repro")
    p = jssm.init_mamba2(key, cfg.d_model, expand=cfg.ssm_expand,
                         head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                         conv_width=cfg.ssm_conv_width, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (C.B_SSM, C.S_SSM, cfg.d_model)) * 0.1
    out["mamba"] = dict(p=jax.tree.map(np.asarray, p), x=np.asarray(x))
    cfgx = C.ssm_cfg("mlstm", "repro")
    x2 = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                      (C.B_SSM, C.S_SSM, cfgx.d_model)) * 0.1)
    out["mlstm"] = dict(p=jax.tree.map(np.asarray, jxlstm.init_mlstm(key, cfgx, jnp.float32)),
                        x=x2)
    out["slstm"] = dict(p=jax.tree.map(np.asarray, jxlstm.init_slstm(key, cfgx, jnp.float32)),
                        x=x2)
    return out


def _step_refs(arch):
    """The reference's ``mesh=None`` prefill / decode steps of one step
    case: (inputs for the ranks, a function that computes the expected
    outputs — called while the ranks run)."""
    cfg = C.step_cfg(arch, "repro")
    model, prefill = jsteps.make_prefill_step(cfg, None)
    params = model.init(jax.random.PRNGKey(0))
    inp = C.step_inputs(arch)
    # decode: the cache of a B_DEC-prompt prefill, ragged lengths
    flat = C.ref_decode_cache(arch, params, inp)
    payload = dict(params=jax.tree.map(np.asarray, params), inputs=inp, dcache=flat)
    return payload, lambda: _step_want(arch, cfg, model, prefill, params, inp, flat)


def _step_want(arch, cfg, model, prefill, params, inp, flat):
    pre = jax.jit(prefill)
    logit_fn = jax.jit(lambda b, p, prm: model.prefill(prm, b, p, last_logit_only=True)[0])
    want = {}
    for n_data in (C.MESH8[0], C.MESH4[0]):
        perm, pos = C.step_layout(arch, n_data)
        batch = {k: jnp.asarray(v) for k, v in
                 dict(inp["extra"], tokens=inp["prompt"][:, perm]).items()}
        nt, cache = pre(batch, jnp.asarray(pos), params)
        want[n_data] = dict(token=np.asarray(nt),
                            logits=np.asarray(logit_fn(batch, jnp.asarray(pos), params)),
                            cache=jax.tree.map(np.asarray, cache._asdict()))
    _, dstep = jsteps.make_decode_step(cfg, None)
    dout = jax.jit(dstep)(jnp.asarray(inp["dtokens"]),
                          {k: jnp.asarray(v) for k, v in flat.items()}, params)
    want["decode"] = {k: np.asarray(v) for k, v in dout.items()}
    return want


def _moe_refs():
    """The `MOE_CASES` variants: (inputs for the ranks, a function that
    computes the reference's `apply_moe` (``mesh=None``) on each
    variant's layer-0 parameters — output, aux loss, dropped fraction, and
    the gradients of ``sum(out * w) + aux``)."""
    payload, cases = {}, {}
    for variant, c in C.moe_inputs().items():
        cfg = C.step_cfg(f"mixtral-8x7b:{variant}", "repro")
        params = j_build_model(cfg).init(jax.random.PRNGKey(0))
        payload[variant] = dict(c, params=jax.tree.map(np.asarray, params))
        cases[variant] = (cfg, params, c)
    return payload, lambda: {v: _moe_want(*a) for v, a in cases.items()}


def _moe_want(cfg, params, c):
    from repro.models import moe as jmoe

    p0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    b, s, d = c["x"].shape

    def run(x, p):
        flat = jnp.swapaxes(x, 0, 1).reshape(b * s, d)
        return jmoe.apply_moe(p, flat, top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              ffn_kind=cfg.ffn_kind)

    def objective(x, p):
        mo = run(x, p)
        return jnp.sum(mo.out * c["w"]) + mo.aux_loss

    x = jnp.asarray(c["x"])
    mo = run(x, p0)
    gx, gp = jax.grad(objective, argnums=(0, 1))(x, p0)
    return dict(out=np.asarray(mo.out), aux=float(mo.aux_loss),
                dropped=float(mo.dropped_frac),
                grads=dict(x=np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}))


def _train_refs(arch):
    """(inputs for the ranks, a function that runs the reference's two
    ``mesh=None`` train steps)."""
    cfg = C.step_cfg(arch, "repro")
    model, step = jsteps.make_train_step(cfg, None, loss_chunk=16,
                                         microbatches=C.MICRO)
    params = model.init(jax.random.PRNGKey(0))
    opt = jsteps.init_opt_state(params)
    batch = TC.batch_for(cfg, b=C.B_TRAIN, t=C.T_TRAIN)

    def want():
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        fn = jax.jit(step)
        outs, p, o = [], params, opt
        for _ in range(2):
            p, o, met = fn(p, o, jb)
            outs.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o),
                         {k: float(v) for k, v in met.items()}))
        return outs

    payload = dict(params=jax.tree.map(np.asarray, params),
                   opt=jax.tree.map(np.asarray, opt), batch=batch)
    return payload, want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Everything that runs in other processes, started together: the
    reference's SPMD code on 8 virtual devices, the torch world of 8 ranks
    and the torch world of 4 ranks (the reference's expected outputs are
    computed here meanwhile)."""
    tmp = tmp_path_factory.mktemp("esp")
    inputs = C.make_inputs()
    inputs["ssm"] = _ssm_inputs()
    inp, outp = tmp / "jax_in.pkl", tmp / "jax_out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_esp_cases as C; C.jax_reference({str(inp)!r}, {str(outp)!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        steps_in, train_in, later = {}, {}, {}
        for arch in C.STEP_ARCHS:
            steps_in[arch], later["steps", arch] = _step_refs(arch)
        for arch in C.TRAIN_ARCHS:
            train_in[arch], later["train", arch] = _train_refs(arch)
        moe_in, later["moe"] = _moe_refs()
        payload = dict(inputs, steps=steps_in, train=train_in, moe=moe_in)
        # both worlds run while this process computes the expected outputs
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            f8 = pool.submit(C.spawn, 8, ["attn", "ssm", "steps8", "moe8"], payload,
                             tmp, timeout=420)
            f4 = pool.submit(C.spawn, 4, ["steps4", "moe4", "train4"], payload, tmp,
                             timeout=420)
            want = {key: fn() for key, fn in later.items()}
            w8, w4 = f8.result(), f4.result()
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out + err
    with open(outp, "rb") as f:
        jout = pickle.load(f)
    return dict(inputs=inputs, jax=jout, w8=w8, w4=w4,
                steps={a: want["steps", a] for a in C.STEP_ARCHS},
                train={a: want["train", a] for a in C.TRAIN_ARCHS}, moe=want["moe"])


def _same_on_every_rank(results, get):
    first = get(results[0])
    for r, res in enumerate(results[1:], 1):
        got = get(res)
        if isinstance(first, (list, tuple)):
            for a, b in zip(first, got):
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(first, got, err_msg=f"rank {r}")


# ====================================================================== (b)
def _prefill_oracle(name, c):
    *_, window, softcap = C.PREFILL_CASES[name]
    q, k, v, pos = (jnp.asarray(c[x]) for x in ("q", "k", "v", "pos"))
    if name != "dop2":
        return np.asarray(JA.full_attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                                            window=window, softcap=softcap))
    half = C.S_ATTN // 2  # two independent requests, one per DoP-2 group
    return np.concatenate([
        np.asarray(JA.full_attention(q[:, sl], k[:, sl], v[:, sl], q_pos=pos[sl],
                                     k_pos=pos[sl], causal=True))
        for sl in (slice(0, half), slice(half, None))], axis=1)


@pytest.mark.parametrize("name", list(C.PREFILL_CASES))
def test_prefill_attn(worlds, name):
    got = worlds["w8"][0]["attn"]["prefill"][name]
    ref = worlds["jax"]["prefill"][name]
    oracle = _prefill_oracle(name, worlds["inputs"]["prefill"][name])
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATTN_TOL)
    if name in C.REFERENCE_FAULTS:
        # the reference slices the ring over tp ranks that hold different
        # batch rows: its output is not attention (ROADMAP §3)
        assert np.abs(ref - oracle).max() > 0.1
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATTN_TOL)
    _same_on_every_rank(worlds["w8"], lambda r: r["attn"]["prefill"][name])
    # the ring runs K4's partial once per step and passes the stripe on
    ring = C.PREFILL_CASES[name][5] or C.MESH8[0]
    counts = worlds["w8"][0]["attn"]["counts"][name]
    assert counts["attention_partial"] == ring
    assert counts["ring_ppermute"] == ring - 1
    sliced = name in ("ring_slice_tp", "ring_slice_tp_batch")
    # the de-dup group's re-gather after each leg
    assert counts.get("all_gather", 0) == (ring - 1 if sliced else 0)


# ====================================================================== (c)
def _decode_oracle(name, c):
    _b, _h, _kvh, _fb, window, softcap = C.DECODE_CASES[name]
    q, kc, vc, kn, vn, cl = (jnp.asarray(c[x]) for x in ("q", "kc", "vc", "kn", "vn", "cl"))
    pos = jnp.arange(kc.shape[1])
    valid = pos[None, :] < cl[:, None]
    if window is not None:
        valid &= pos[None, :] > cl[:, None] - window
    hist = JA.partial_attention(q, kc, vc, valid[:, None, :], softcap=softcap)
    new = JA.partial_attention(q, kn, vn, None, softcap=softcap)
    return np.asarray(JA.finalize_partial(JA.merge_partial(hist, new)))


@pytest.mark.parametrize("name", list(C.DECODE_CASES))
def test_decode_attn(worlds, name):
    got = worlds["w8"][0]["attn"]["decode"][name]
    ref = worlds["jax"]["decode"][name]
    oracle = _decode_oracle(name, worlds["inputs"]["decode"][name])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATTN_TOL)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATTN_TOL)
    _same_on_every_rank(worlds["w8"], lambda r: r["attn"]["decode"][name])
    counts = worlds["w8"][0]["attn"]["counts"]["decode_" + name]
    assert counts["decode_partial"] == 1  # K5 over this rank's KV shard
    multi = C.DECODE_CASES[name][0] % C.MESH8[0] == 0
    assert counts.get("psum_scatter", 0) == (1 if multi else 0)


def test_split_dim_block_order(worlds):
    """A dim split over ("data", "model") puts block i * n_model + j on rank
    (i, j): the order decode mode 2's shard offsets rely on."""
    for res in worlds["w8"]:
        i, j, local = res["attn"]["order"]
        blk = 16 // 8
        start = (i * C.MESH8[1] + j) * blk
        np.testing.assert_array_equal(local, np.arange(start, start + blk))


# ====================================================================== (d)
@pytest.mark.parametrize("kind", C.SSM_KINDS)
def test_ssm_sp(worlds, kind):
    c = worlds["inputs"]["ssm"][kind]
    y, st, _ = worlds["w8"][0]["ssm"][kind]
    jy, jst = worlds["jax"]["ssm"][kind]
    np.testing.assert_allclose(y, jy, rtol=0, atol=SSM_TOL)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a, b, rtol=0, atol=SSM_TOL)
    cfg = C.ssm_cfg(kind, "repro")
    p = jax.tree.map(jnp.asarray, c["p"])
    x = jnp.asarray(c["x"])
    if kind == "mamba":
        y1, st1 = jssm.mamba2_forward(p, x, cfg, None)
    elif kind == "mlstm":
        y1, st1 = jxlstm.mlstm_block_forward(p, x, cfg, None, chunk=16)
    else:
        y1, st1 = jxlstm.slstm_block_forward(p, x, cfg, None)
    np.testing.assert_allclose(y, np.asarray(y1), rtol=0, atol=SSM_TOL)
    for a, b in zip(st, st1):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=SSM_TOL)
    # (f) the final state is replicated over "data": every rank's copy
    # (its batch block) is the same block of the global state
    _same_on_every_rank(worlds["w8"], lambda r: r["ssm"][kind][0])


# ====================================================================== (e)
def _cache_leaves(tree):
    out = {}
    for k, v in tree.items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            for i, sub in enumerate(v):
                if isinstance(sub, (list, tuple)):
                    for j, leaf in enumerate(sub):
                        out[f"{k}/{i}/{j}"] = np.asarray(leaf)
                else:
                    out[f"{k}/{i}"] = np.asarray(sub)
        else:
            out[k] = np.asarray(v)
    return out


STEP_CASES = [(a, m) for m in ("8", "4") for a in C.STEP_ARCHS]


@pytest.mark.parametrize("arch,world", STEP_CASES,
                         ids=[f"{a}-{'4x2' if w == '8' else '2x2'}" for a, w in STEP_CASES])
def test_prefill_step(worlds, arch, world):
    res = worlds["w" + world]
    n_data = C.MESH8[0] if world == "8" else C.MESH4[0]
    want = worlds["steps"][arch][n_data]
    got = res[0]["steps" + world][arch]
    np.testing.assert_array_equal(got["prefill_token"], want["token"])
    np.testing.assert_allclose(got["prefill_logits"], want["logits"], rtol=0, atol=STEP_TOL)
    gc, wc = _cache_leaves(got["prefill_cache"]), _cache_leaves(want["cache"])
    assert set(gc) == set(wc), (sorted(gc), sorted(wc))
    for key in wc:
        np.testing.assert_allclose(gc[key], wc[key], rtol=0, atol=STEP_TOL, err_msg=key)
    if world == "8" and arch in C.MESH_REF_ARCHS:
        # the reference's own mesh-aware prefill on the (4, 2) Auto mesh
        ref = worlds["jax"]["steps"][arch]
        np.testing.assert_array_equal(got["prefill_token"], ref["token"])
        np.testing.assert_allclose(got["prefill_logits"], ref["logits"], rtol=0, atol=STEP_TOL)
        for key, w in ref["cache"].items():
            np.testing.assert_allclose(gc[key], w, rtol=0, atol=STEP_TOL, err_msg=key)
    _same_on_every_rank(res, lambda r: r["steps" + world][arch]["prefill_token"])
    counts = got["prefill_counts"]
    cfg = C.step_cfg(arch)
    if cfg.n_attention_applications:
        # one K4 partial per ring step per attention layer
        assert counts["attention_partial"] == cfg.n_attention_applications * n_data
    if cfg.family in ("hybrid", "ssm"):
        assert counts["ppermute"] > 0  # the recurrent layers' state handoff


@pytest.mark.parametrize("arch,world", STEP_CASES,
                         ids=[f"{a}-{'4x2' if w == '8' else '2x2'}" for a, w in STEP_CASES])
def test_decode_step(worlds, arch, world):
    res = worlds["w" + world]
    want = worlds["steps"][arch]["decode"]
    got = res[0]["steps" + world][arch]["decode"]
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["next_token"], want["next_token"])
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=STEP_TOL, err_msg=key)
    if world == "8" and arch in C.MESH_REF_ARCHS:
        # the reference's own mesh-aware decode on the (4, 2) Auto mesh
        for key, w in worlds["jax"]["steps"][arch]["decode"].items():
            np.testing.assert_allclose(got[key], w, rtol=0, atol=STEP_TOL, err_msg=key)
        np.testing.assert_array_equal(got["next_token"],
                                      worlds["jax"]["steps"][arch]["decode"]["next_token"])
    _same_on_every_rank(res, lambda r: r["steps" + world][arch]["decode_token_local"])
    cfg = C.step_cfg(arch)
    counts = res[0]["steps" + world][arch]["decode_counts"]
    assert counts.get("decode_partial", 0) == cfg.n_attention_applications


MOE_IDS = [f"{v}-{k}-{w}" for w in ("4x2", "2x2") for v, k in C.MOE_CASES]


@pytest.mark.parametrize("case", MOE_IDS)
def test_moe_routing_on_mesh(worlds, case):
    """`apply_moe` on the mesh routes globally: its dropped fraction
    equals the reference's ``mesh=None`` routing's, its aux loss within
    1e-5 relative (f32 sums), its output within 1e-4, and in the train
    kind the gradients of ``sum(out * w) + aux`` within 1e-4 of
    ``jax.grad``'s.  ``drop`` drops assignments; ``e3`` (3 experts over a
    2-way model axis) runs TP inside each expert."""
    variant, kind, mesh_id = case.split("-")
    world = "8" if mesh_id == "4x2" else "4"
    want = worlds["moe"][variant]
    got = worlds["w" + world][0]["moe" + world][(variant, kind)]
    assert got["dropped"] == pytest.approx(want["dropped"], abs=1e-7)
    if variant == "drop":
        assert want["dropped"] > 0.05  # the capacity bites
    assert abs(got["aux"] - want["aux"]) <= 1e-5 * abs(want["aux"])
    np.testing.assert_allclose(got["out"], want["out"], rtol=0, atol=STEP_TOL)
    if kind == "train":
        assert set(got["grads"]) == set(want["grads"])
        for key, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][key], w, rtol=0,
                                       atol=STEP_TOL * max(np.abs(w).max(), 1.0),
                                       err_msg=key)
    _same_on_every_rank(worlds["w" + world],
                        lambda r: [r["moe" + world][(variant, kind)]["out"]])
    tcfg = C.step_cfg(f"mixtral-8x7b:{variant}")
    ep = tcfg.n_experts % C.MESH8[1] == 0
    assert ep == (variant != "e3")


def _block(arr, spec, coords, sizes):
    """The block of ``arr`` a rank at ``coords`` holds under ``spec``."""
    out = arr
    for d, ent in enumerate(tuple(spec) + (None,) * (arr.ndim - len(spec))):
        if ent is None:
            continue
        axes = ent if isinstance(ent, tuple) else (ent,)
        idx, ways = 0, 1
        for a in axes:
            idx, ways = idx * sizes[a] + coords[a], ways * sizes[a]
        n = arr.shape[d] // ways
        out = np.take(out, np.arange(idx * n, (idx + 1) * n), axis=d)
    return out


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_train_step_zero1(worlds, arch):
    want = worlds["train"][arch]
    res = worlds["w4"]
    tcfg = C.step_cfg(arch)
    specs = tsteps.opt_shardings(tcfg, MeshShape(C.MESH4, ("data", "model")),
                                 param_shapes(tcfg))["m"]
    explained = {}
    for n, ((jp, jo, jmet), got) in enumerate(zip(want, res[0]["train4"][arch]), 1):
        for key in ("loss", "aux", "grad_norm"):
            tol = LOSS_RTOL if key == "loss" else 1e-4
            assert abs(got["metrics"][key] - jmet[key]) <= tol * max(abs(jmet[key]), 1e-6), \
                (key, got["metrics"][key], jmet[key])
        tout = (got["params"], {"m": got["m"], "v": got["v"], "step": got["step"]},
                got["metrics"])
        TC.hold((jp, jo, jmet), tout, n, explained)
        # ZeRO-1: each rank's local moment shard is its block of the
        # reference's moments
        jm = TC.flat(jo["m"])
        for r in res:
            i, j = r["train4"]["coords"]
            local = TC.flat(r["train4"][arch][n - 1]["m_local"])
            for key, spec in TC.flat(specs).items():
                blk = _block(jm[key], spec, {"data": i, "model": j},
                             {"data": C.MESH4[0], "model": C.MESH4[1]})
                assert local[key].shape == blk.shape, (key, local[key].shape, blk.shape)
                np.testing.assert_allclose(local[key], blk, rtol=0,
                                           atol=1e-4 * np.abs(jm[key]).max(), err_msg=key)
    # (f) the metrics are identical on every rank
    _same_on_every_rank(res, lambda r: [np.asarray(list(s["metrics"].values()))
                                        for s in r["train4"][arch]])
    assert any(isinstance(s, tuple) and "data" in s or s == "data"
               for spec in TC.flat(specs).values() for s in spec), \
        "some moment is sharded over data"
