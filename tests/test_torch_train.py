"""The port's training path against the JAX reference on the CPU: the plain
K4 backward, `StripedFlashAttentionFn`, `launch/steps.py`'s train, prefill
and decode steps, and the repair that keeps K1, K2, K3 and K5 out of any
gradient.

Tolerances, f32 throughout.
  * The plain backward against ``jax.vjp`` of the reference's
    `full_attention`: 1e-4 x max|ref| per tensor (the same f32 math in
    another order, over at most a few dozen keys).
  * `gradcheck` of the `Function` in f64 (torch's default tolerances).
  * The train steps against the reference's: `test_torch_train_steps.py`.
  * remat on against remat off: identical (the same ops recomputed).
  * int8 compression: equal to the reference's bit for bit.
  * Prefill / decode steps: the same next tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_flash_decode as tpfd  # noqa: E402
from repro_torch.kernels import paged_flash_prefill as tpfp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import striped_attention as tsa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402

from torch_train_cases import batch_for, flat, hold, np_, setup  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These reduced shapes gain nothing from intra-op threads, and under a
    multi-worker run they only contend (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the K4 backward

# (B, Sq, Sk, H, KVH, D, causal, window, softcap, q_pos, k_pos)
_rp = np.random.default_rng(5)
BWD_CASES = {
    "causal GQA 2": (2, 12, 12, 4, 2, 16, True, None, None,
                     np.arange(12), np.arange(12)),
    "window GQA 4": (1, 17, 17, 8, 2, 8, True, 5, None,
                     np.arange(17), np.arange(17)),
    "softcap": (2, 9, 9, 4, 4, 16, True, None, 2.0, np.arange(9), np.arange(9)),
    "non-causal Sq != Sk": (2, 7, 11, 4, 1, 8, False, None, None,
                            np.arange(7), np.arange(11)),
    "striped shards": (1, 8, 8, 4, 2, 16, True, 9, None,
                       np.arange(8) * 4 + 3, np.arange(8) * 4 + 1),
    "unsorted window softcap": (2, 10, 13, 4, 2, 8, True, 6, 3.0,
                                _rp.permutation(16)[:10], _rp.permutation(16)[:13]),
    "empty rows": (1, 6, 6, 2, 2, 8, True, None, None,
                   np.arange(6), np.arange(6) + 3),
}


def _bwd_inputs(case, seed=0, dtype=np.float32):
    b, sq, sk, h, kvh, d, *_ = case
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(dtype) for s in
            ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d), (b, sq, h, d))]


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_plain_backward_matches_jax_vjp(name):
    case = BWD_CASES[name]
    causal, window, softcap, qp, kp = case[6:]
    q, k, v, do = _bwd_inputs(case)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def f(q_, k_, v_):
        return JA.full_attention(q_, k_, v_, q_pos=jnp.asarray(qp),
                                 k_pos=jnp.asarray(kp), **kw)

    o_ref, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.striped_flash_attention_ref_lse(tq, tk, tv, qp, kp, **kw)
    np.testing.assert_allclose(np_(o), np.asarray(o_ref), atol=2e-5)
    got = tref.striped_flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, qp, kp, **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np_(g), w, atol=1e-4 * np.abs(w).max())
    # evaluated in q-row blocks, the plain backward is the same
    blocked = tref.striped_flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, qp,
                                                   kp, rows=4, **kw)
    for g, w in zip(blocked, got):
        np.testing.assert_allclose(np_(g), np_(w), atol=1e-6)
    if name == "empty rows":  # q positions before every key: exact zeros
        assert torch.isinf(lse[:, :, :3]).all() and (lse[:, :, :3] > 0).all()
        assert (got[0][:, :3] == 0).all() and not torch.isnan(got[0]).any()


# tiny cases for the f64 gradcheck (one forward per perturbed element):
# GQA 2 with a window, softcap and unsorted positions; non-causal Sq != Sk;
# empty rows
GRADCHECK_CASES = {
    "window GQA 2": (1, 6, 6, 4, 2, 4, True, 3, None, np.arange(6), np.arange(6)),
    "unsorted window softcap": (1, 5, 7, 2, 1, 4, True, 4, 3.0,
                                _rp.permutation(9)[:5], _rp.permutation(9)[:7]),
    "non-causal Sq != Sk": (1, 4, 6, 2, 2, 4, False, None, None,
                            np.arange(4), np.arange(6)),
    "empty rows": (1, 5, 5, 2, 1, 4, True, None, None, np.arange(5),
                   np.arange(5) + 2),
}


@pytest.mark.parametrize("name", list(GRADCHECK_CASES))
def test_function_gradcheck_f64(name):
    case = GRADCHECK_CASES[name]
    causal, window, softcap, qp, kp = case[6:]
    q, k, v, _ = (torch.from_numpy(x).requires_grad_(True)
                  for x in _bwd_inputs(case, seed=1, dtype=np.float64))
    qp, kp = torch.as_tensor(qp), torch.as_tensor(kp)

    def fn(q_, k_, v_):
        return tsa.StripedFlashAttentionFn.apply(q_, k_, v_, qp, kp, causal,
                                                 window, softcap)

    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_k4_under_grad_takes_the_function():
    case = BWD_CASES["causal GQA 2"]
    q, k, v, do = (torch.from_numpy(x) for x in _bwd_inputs(case))
    pos = torch.arange(12)
    plain = tsa.striped_flash_attention(q, k, v, pos, pos)
    assert plain.grad_fn is None
    q.requires_grad_(True)
    out = tsa.striped_flash_attention(q, k, v, pos, pos)
    assert type(out.grad_fn).__name__ == "StripedFlashAttentionFnBackward"
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    with torch.no_grad():
        assert tsa.striped_flash_attention(q, k, v, pos, pos).grad_fn is None
    (dq,) = torch.autograd.grad(out, q, do)
    lse = tref.striped_flash_attention_ref_lse(q.detach(), k, v, pos, pos)[1]
    want = tref.striped_flash_attention_bwd_ref(q.detach(), k, v, plain, do, lse,
                                                pos, pos)[0]
    torch.testing.assert_close(dq, want, rtol=0, atol=0)


def test_serving_kernels_refuse_grad():
    """K1, K2, K3 and K5 have no backward: under grad, with an input that
    requires grad, every entry point raises (on any device), and with grad
    off it runs."""
    r = np.random.default_rng(2)
    t, h, d = 10, 2, 8
    q = torch.from_numpy(r.normal(size=(t, h, d)).astype(np.float32))
    k, v = torch.randn(t, h, d), torch.randn(t, h, d)
    off = torch.tensor([0, 4, 10], dtype=torch.int32)
    kd, vd = torch.randn(2, 5, h, d), torch.randn(2, 5, h, d)
    lens = torch.tensor([3, 5])
    pages = torch.randn(4, 4, h, d)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    calls = {
        "prefill_packed": lambda q_: ops.prefill_packed(q_, k, v, off),
        "prefill_ring_chunk": lambda q_: ops.prefill_ring_chunk(
            q_, k, v, off, off, q_shard=0, k_shard=0, n_shards=1),
        "decode_partial": lambda q_: ops.decode_partial(q_[:2, None], kd, vd, lens),
        "paged_decode_partial": lambda q_: ops.paged_decode_partial(
            q_[:2, None], pages, pages, bt, lens),
        "packed_flash_prefill": lambda q_: tpfp.packed_flash_prefill(q_, k, v, off),
        "flash_decode_partial": lambda q_: tfd.flash_decode_partial(
            q_[:2, None], kd, vd, lens),
        "paged_flash_decode_partial": lambda q_: tpfd.paged_flash_decode_partial(
            q_[:2, None], pages, pages, bt, lens),
    }
    for name, call in calls.items():
        call(q)  # nothing requires grad: runs
        with pytest.raises(RuntimeError, match="no backward"):
            call(q.clone().requires_grad_(True))
        with torch.no_grad():
            call(q.clone().requires_grad_(True))
    carry = (torch.zeros(t, h, d, requires_grad=True), torch.full((t, h), -torch.inf),
             torch.zeros(t, h))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.prefill_ring_chunk(q, k, v, off, off, carry, q_shard=0, k_shard=0,
                               n_shards=1)


# ------------------------------------------------------------ train steps


@pytest.mark.parametrize("arch", ["lwm-7b", "zamba2-2.7b", "xlstm-350m",
                                  "whisper-tiny"])
def test_remat_equals_no_remat(arch):
    cfg = t_reduced(T_REGISTRY[arch])
    tree = jax.tree.map(np.asarray, jsteps.build_model_for(
        reduced(REGISTRY[arch]), None, "train").init(jax.random.PRNGKey(0)))
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    outs = []
    spans = {}
    for remat in (False, True):
        _, step = tsteps.make_train_step(cfg, None, loss_chunk=16, remat=remat,
                                         device="cpu")
        params = params_from_numpy(cfg, tree, device="cpu")
        outs.append(step(params, tsteps.init_opt_state(params), batch,
                         spans=spans if remat else None))
    (p0, o0, m0), (p1, o1, m1) = outs
    # the step's phase spans (the host clock on the CPU)
    assert set(spans) == {"forward", "backward", "optimizer"}
    assert all(v > 0 for v in spans.values()), spans
    for key in m0:
        torch.testing.assert_close(m1[key], m0[key], rtol=0, atol=0)
    for a, b in zip(tsteps.tree_leaves(o0["m"]) + tsteps.tree_leaves(p0),
                    tsteps.tree_leaves(o1["m"]) + tsteps.tree_leaves(p1)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_compress_int8_matches_reference():
    """The reference's `compress` on one gradient tree (f32 and bf16
    leaves; an int leaf passes through), bit for bit."""
    r = np.random.default_rng(7)
    tree = {"a": (r.normal(size=(64, 33)) * 1e-3).astype(np.float32),
            "b": r.normal(size=(17,)).astype(np.float32),
            "z": np.zeros((5,), np.float32),
            "h": (r.normal(size=(40, 8)) * 3).astype(jnp.bfloat16),
            "i": np.arange(6, dtype=np.int32)}
    def j_q(x):
        """The leaf function of the reference's `compress`, a closure of its
        train step (`src/repro/launch/steps.py:382-388`), as written there;
        `test_int8_train_step_matches_reference` holds the closure itself."""
        if x.dtype not in (jnp.float32, jnp.bfloat16):
            return x
        scale = jnp.maximum(jnp.max(jnp.abs(x)), 1e-8) / 127.0
        xi = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
        return (xi.astype(x.dtype) * scale).astype(x.dtype)

    for key, x in tree.items():
        want = np.asarray(jax.jit(j_q)(jnp.asarray(x)))
        tx = (torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
              if x.dtype == jnp.bfloat16 else torch.from_numpy(x))
        got = tsteps.compress_int8(tx)
        assert got.dtype == tx.dtype, key
        got = got.view(torch.int16).numpy().view(jnp.bfloat16) \
            if got.dtype == torch.bfloat16 else got.numpy()
        np.testing.assert_array_equal(got.astype(np.float32),
                                      want.astype(np.float32), err_msg=key)


# --------------------------------------------------- prefill / decode steps


def _flat_cache(cache, pad):
    """The flat decode-step dict of a prefilled cache (either package's
    `Cache`; numpy out), KV padded to ``pad`` slots."""
    flat = {"length": np.asarray(np_(cache.length), np.int32)}
    if cache.k is not None:
        k, v = np_(cache.k), np_(cache.v)
        shape = k.shape[:2] + (pad,) + k.shape[3:]
        for name, x in (("k", k), ("v", v)):
            z = np.zeros(shape, np.float32)
            z[:, :, :x.shape[2]] = x
            flat[name] = z
    if cache.ssm is not None and hasattr(cache.ssm, "h"):
        flat["ssm_h"], flat["ssm_conv"] = np_(cache.ssm.h), np_(cache.ssm.conv)
    elif cache.ssm is not None:
        mst, sst = cache.ssm
        flat.update(xl_c=np_(mst.c), xl_n=np_(mst.n), xl_m=np_(mst.m),
                    sl_c=np_(sst.c), sl_n=np_(sst.n), sl_h=np_(sst.h),
                    sl_m=np_(sst.m))
    if cache.cross_k is not None:
        flat["cross_k"], flat["cross_v"] = np_(cache.cross_k), np_(cache.cross_v)
    return flat


@pytest.mark.parametrize("arch", ["lwm-7b", "mixtral-8x7b", "zamba2-2.7b",
                                  "xlstm-350m", "whisper-tiny"])
def test_prefill_and_decode_steps_match_reference(arch):
    jcfg, tcfg = reduced(REGISTRY[arch]), t_reduced(T_REGISTRY[arch])
    jm, jpre = jsteps.make_prefill_step(jcfg, None)
    _, jdec = jsteps.make_decode_step(jcfg, None)
    _, tpre = tsteps.make_prefill_step(tcfg, None, device="cpu")
    _, tdec = tsteps.make_decode_step(tcfg, None, device="cpu")
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = batch_for(jcfg, t=20, seed=4)
    batch.pop("labels")
    t = batch["tokens"].shape[1] + (jcfg.n_frontend_tokens
                                    if jcfg.frontend == "patch_stub" else 0)
    jnext, jcache = jax.jit(jpre)({k: jnp.asarray(v) for k, v in batch.items()},
                                  jnp.arange(t), jp)
    tnext, tcache = tpre({k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.arange(t), tp)
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
    jflat, tflat = _flat_cache(jcache, t + 4), _flat_cache(tcache, t + 4)
    for key in jflat:
        np.testing.assert_allclose(tflat[key], jflat[key], atol=1e-4, err_msg=key)
    tok = np.asarray(jnext)
    jout = jax.jit(jdec)(jnp.asarray(tok), {k: jnp.asarray(v) for k, v in jflat.items()}, jp)
    tout = tdec(torch.from_numpy(tok), {k: torch.from_numpy(v) for k, v in jflat.items()}, tp)
    assert set(tout) == set(jout)
    np.testing.assert_array_equal(tout["next_token"].numpy(),
                                  np.asarray(jout["next_token"]))
    for key in jout:
        np.testing.assert_allclose(np_(tout[key]), np.asarray(jout[key]), atol=1e-4,
                                   err_msg=key)


def test_mesh_steps_wait_for_the_dry_run_slice(tmp_path):
    """A moe model's train step on a mesh — which waited for ROADMAP item
    14.1b until it was ported — runs: two ZeRO-1 steps of reduced mixtral
    on a (1, 1) gloo mesh in this process meet the AdamW rule against the
    reference's ``mesh=None`` jitted step (the (2, 2) world of
    tests/test_torch_esp_spmd.py holds the sharded case)."""
    import torch.distributed as dist

    from repro_torch.launch import sharding as tshard
    from repro_torch.launch.mesh import init_process_group, make_test_mesh

    (jstep, jp, jo, jb), (_, tp, to, tb) = setup("mixtral-8x7b")
    init_process_group("cpu", init_method=f"file://{tmp_path / 'pg'}",
                       world_size=1, rank=0)
    try:
        mesh = make_test_mesh(1, 1, device="cpu")
        tcfg = t_reduced(T_REGISTRY["mixtral-8x7b"])
        _, mstep = tsteps.make_train_step(tcfg, mesh, loss_chunk=16, device="cpu")
        params = tsteps.place_params(tcfg, mesh, tp, train=True)
        opt = tsteps.place_opt_state(tcfg, mesh, to)
        batch = tshard.distribute(tb, mesh, {k: tshard.P() for k in tb})
        explained = {}
        for n in (1, 2):
            jp, jo, jmet = jstep(jp, jo, jb)
            params, opt, met = mstep(params, opt, batch)
            full = tsteps.tree_map(tsteps.full_value, params)
            mo = {k: tsteps.tree_map(tsteps.full_value, opt[k]) for k in ("m", "v")}
            hold((jp, jo, jmet), (full, dict(mo, step=opt["step"]), met), n, explained)
    finally:
        dist.destroy_process_group()
