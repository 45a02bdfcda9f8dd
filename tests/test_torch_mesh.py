"""The port's mesh executor on `torch.distributed`, across processes on the
CPU (gloo), held to the JAX reference.

The JAX expectations are computed here, in the test process, on one device:
`kref.packed_prefill_ref` for the ring, `kref.paged_decode_merge_ref` /
`kref.paged_decode_batch_sharded_ref` for the decode merges, the JAX
`LoongServeEngine` on its `LocalExecutor` and `kref.serial_decode_oracle`
for the engine's tokens.  (The reference's own SPMD ring program cannot be
the oracle on this jax: it stops in `striped.unstripe` with a
`ShardingTypeError` under jax 0.9's explicit mesh axes.)

The torch ranks are spawned by `tests/torch_mesh_cases.py` at world sizes 2
and 4 — one spawn per world size, every case of that world in it — and 8
for the ring alone (DoP 4 x model 2); they import only `repro_torch`.
Every rank's tokens must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mesh_exec_cases as jcases  # noqa: E402
import torch_mesh_cases as C  # noqa: E402
from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.core import striped as jstriped  # noqa: E402
from repro.engine.server import LoongServeEngine as JEngine  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.core import striped as tstriped  # noqa: E402

N_LAYERS = 2
ATOL = 2e-5
VARIANTS = [(None, None), (7, None), (None, 5.0)]  # GQA, window, softcap
DVARIANTS = [(None, None), (9, None), (None, 5.0)]
LENGTHS = [33, 17, 50, 8]
SEED = {2: 25, 4: 27}  # prompt seed of the DoP-2 / DoP-4 engine runs
RING_MESHES = {2: [(2, 1)], 4: [(4, 1), (2, 2)], 8: [(4, 2)]}  # (data, model)
DECODE_LENS = [13, 1, 29, 8, 22, 40, 5, 17]  # B = 8: divisible by 2 and 4


@pytest.fixture(scope="module")
def jax_model():
    cfg = reduced(REGISTRY["lwm-7b"], n_layers=N_LAYERS)
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


@pytest.fixture(scope="module")
def payload(jax_model):
    _, _, params = jax_model
    q, k, v, off = jcases._packed_case(0, [5, 1, 17, 9, 12], 4, 2, 32, 64)
    rng = np.random.default_rng(5)
    h, kvh, d, page = 4, 2, 32, 4
    b = len(DECODE_LENS)
    dq = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    dk = rng.normal(size=(b, 1, kvh, d)).astype(np.float32)
    dv = rng.normal(size=(b, 1, kvh, d)).astype(np.float32)
    shards = {n: jcases._build_paged_shards(rng, n, DECODE_LENS, kvh, d, page)[2]
              for n in (2, 4)}
    return dict(
        n_layers=N_LAYERS, params=jax.tree.map(np.asarray, params),
        q=q, k=k, v=v, off=off, variants=VARIANTS, ring_meshes=RING_MESHES,
        dq=dq, dk=dk, dv=dv, dlens=np.asarray(DECODE_LENS, np.int32),
        shards=shards, dvariants=DVARIANTS, lengths=LENGTHS, seed=SEED,
    )


@pytest.fixture(scope="module")
def world2(payload, tmp_path_factory):
    return C.spawn(2, ["ring", "decode", "engine", "arms", "join",
                       "checkpoint", "unified", "guards"],
                   payload, tmp_path_factory.mktemp("w2"), timeout=480)


@pytest.fixture(scope="module")
def world4(payload, tmp_path_factory):
    return C.spawn(4, ["ring", "decode", "engine", "engine_model2"],
                   payload, tmp_path_factory.mktemp("w4"), timeout=480)


@pytest.fixture(scope="module")
def world8(payload, tmp_path_factory):
    """Eight ranks, the ring alone: DoP 4 with a model axis of 2."""
    return C.spawn(8, ["ring"], payload, tmp_path_factory.mktemp("w8"),
                   timeout=480)


@pytest.fixture(scope="module")
def oracle(jax_model):
    """Memoized JAX serial oracle: greedy tokens of (prompt, n_new)."""
    _, model, params = jax_model
    memo = {}

    def tokens(prompt, n_new):
        key = (tuple(prompt), n_new)
        if key not in memo:
            memo[key] = kref.serial_decode_oracle(model, params, list(prompt),
                                                  n_new - 1)
        return memo[key]

    return tokens


def _worlds(world2, world4, n):
    return {2: world2, 4: world4}[n]


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        assert res[key] == first, (key, r)
    return first


# --------------------------------------------------------------- striped
@pytest.mark.parametrize("n,g", [(2, None), (4, None), (8, 4)])
def test_chunk_provenance_matches_schedule(n, g):
    sched = tstriped.ring_chunk_schedule(n, g)
    assert sched == jstriped.ring_chunk_schedule(n, g)
    assert tstriped.ring_pairs(n, g) == jstriped.ring_pairs(n, g)
    for s in range(g or n):
        assert tstriped.chunk_provenance(n, s, g) == sched[s], (n, g, s)
    x = torch.arange(24.0).reshape(2, 12)
    np.testing.assert_array_equal(
        tstriped.stripe(x, 4, axis=1).numpy(),
        np.asarray(jstriped.stripe(jnp.asarray(x.numpy()), 4, axis=1)))
    np.testing.assert_array_equal(
        tstriped.striped_positions(12, 4, 3).numpy(),
        np.asarray(jstriped.striped_positions(12, 4, 3)))


# ------------------------------------------------------------------ ring
@pytest.mark.parametrize("world,data,model",
                         [(2, 2, 1), (4, 4, 1), (4, 2, 2), (8, 4, 2)])
def test_ring_parity(world, data, model, payload, request):
    """`ring_packed_prefill_spmd` == the dense packed oracle for
    {GQA, window, softcap} x double_buffer {T, F}, on every rank (each
    "model" column runs its own ring: attention is replicated over it)."""
    results = request.getfixturevalue(f"world{world}")
    total = int(payload["off"][-1])
    q, k, v = (jnp.asarray(payload[x]) for x in "qkv")
    for window, softcap in VARIANTS:
        want = np.asarray(kref.packed_prefill_ref(
            q, k, v, jnp.asarray(payload["off"]), window=window,
            softcap=softcap))
        for db in (True, False):
            key = (data, model, window, softcap, db)
            for res in results:
                np.testing.assert_allclose(
                    res["ring"][key][:total], want[:total], atol=ATOL,
                    err_msg=str(key))


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("world", [2, 4])
def test_spmd_decode_parity(world, payload, world2, world4):
    """`paged_decode_spmd` == `paged_decode_merge_ref` and the batch-sharded
    boundary's slices == `paged_decode_batch_sharded_ref`, overlap {T, F}."""
    results = _worlds(world2, world4, world)
    shards = [tuple(jnp.asarray(x) for x in s) for s in payload["shards"][world]]
    q, kn, vn = (jnp.asarray(payload[x]) for x in ("dq", "dk", "dv"))
    cl = jnp.asarray(payload["dlens"])
    for window, softcap in DVARIANTS:
        sh = [s if window is not None else s[:4] + (None,) for s in shards]
        merge = np.asarray(kref.paged_decode_merge_ref(
            q, kn, vn, sh, query_pos=cl, window=window, softcap=softcap))
        bsh = np.asarray(kref.paged_decode_batch_sharded_ref(
            q, kn, vn, sh, query_pos=cl, window=window, softcap=softcap))
        for overlap in (True, False):
            for res in results:
                np.testing.assert_allclose(
                    res["decode"][("spmd", window, softcap, overlap)], merge,
                    atol=ATOL, err_msg=str((world, window, softcap, overlap)))
            got = np.concatenate([res["decode"][("sharded", window, softcap,
                                                 overlap)] for res in results])
            np.testing.assert_allclose(got, bsh, atol=ATOL,
                                       err_msg=str((world, window, softcap)))


# ---------------------------------------------------------------- engine
def _jax_engine_tokens(jax_model, dop):
    cfg, model, params = jax_model
    eng = JEngine(cfg, dop, 4000, store_values=True, model=model,
                  params=params, page_size=16)
    rng = np.random.default_rng(SEED[dop])
    batch = jcases._prefill_batch(eng, rng, LENGTHS, max_new=C.NEW_TOKENS)
    reqs = list(batch.requests)
    eng._on_prefill_done(batch)
    eng._push(eng.clock, "join", 0)
    m = eng.run()
    assert len(m.finished) == len(reqs)
    return [list(r.prompt) for r in reqs], [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("world", [2, 4])
def test_engine_e2e(world, jax_model, oracle, world2, world4):
    """The engine through the MeshExecutor at DoP = world: the ring runs
    across the ranks (no in-process replay, no serial prefill), one ring
    leg per ring step, KV written through in place, and the tokens equal
    the JAX engine's and the serial oracle's on every rank."""
    results = _worlds(world2, world4, world)
    got = [res["engine"]["tokens"] for res in results]
    assert all(g == got[0] for g in got)
    prompts, want = _jax_engine_tokens(jax_model, world)
    assert got[0] == want
    for p, t in zip(prompts, got[0]):
        assert t == oracle(p, C.NEW_TOKENS)
    for res in results:
        d = res["engine"]["prefill_counts"]
        assert d.get("prefill_ring_spmd", 0) >= 1, d
        assert d.get("prefill_ring_replay", 0) == 0, d
        assert d.get("prefill_serial_model", 0) == 0, d
        assert d["ring_ppermute"] == (world - 1) * d["prefill_ring_spmd"], d
        assert d["prefill_ring_chunk"] == world * d["prefill_ring_spmd"], d
        d = res["engine"]["counts"]
        c = res["engine"]["bytes"]
        assert d.get("decode_merge_loop", 0) == 0, d
        assert d.get("decode_iteration_spmd", 0) >= 1, d
        assert d.get("paged_decode_sharded", 0) >= 1, d
        assert d.get("psum_scatter", 0) >= 1 and d.get("pmax", 0) >= 1, d
        assert c.get("psum_scatter", 0) > 0 and c.get("all_gather", 0) > 0, c


def test_engine_model_axis(jax_model, oracle, world4):
    """DoP 2 on a (2, 2) mesh: each "model" column runs its own ring and
    merge (attention replicated over "model"); same tokens as the JAX
    engine, on all four ranks."""
    got = _same_on_every_rank([r["engine_model2"] for r in world4], "tokens")
    _, want = _jax_engine_tokens(jax_model, 2)
    assert got == want
    for res in world4:
        assert res["engine_model2"]["prefill_counts"]["prefill_ring_spmd"] >= 1


@pytest.mark.parametrize("arm", ["replicated", "barrier", "loop",
                                 "sequential_ring"])
def test_decode_arms(arm, world2):
    """``batch_shard=False`` (pmax + psum per layer), ``decode_overlap=False``,
    ``spmd_decode=False`` (the per-shard loop, partials broadcast home) and
    ``double_buffer=False`` give the default arm's tokens."""
    default = _same_on_every_rank([r["engine"] for r in world2], "tokens")
    got = _same_on_every_rank([r["arms"][arm] for r in world2], "tokens")
    assert got == default
    d = world2[0]["arms"][arm]["counts"]
    c = world2[0]["arms"][arm]["bytes"]
    if arm == "replicated":
        assert d.get("paged_decode_spmd", 0) >= 1, d
        assert d.get("decode_iteration_spmd", 0) == 0, d
        assert d.get("psum", 0) >= 1 and c.get("psum", 0) > 0, (d, c)
    elif arm == "loop":
        assert d.get("paged_decode_spmd", 0) == 0, d
        assert d.get("decode_iteration_spmd", 0) == 0, d
        assert d.get("decode_merge_loop", 0) >= 1, d
        assert c.get("decode_partial_home", 0) > 0, c
    else:
        assert d.get("decode_iteration_spmd", 0) >= 1, d
        assert d.get("decode_merge_loop", 0) == 0, d


def test_fail_and_join(oracle, world2):
    """fail_instance mid-decode + join_instance on the mesh executor."""
    res = world2[0]["join"]
    _same_on_every_rank([r["join"] for r in world2], "tokens")
    for p, t in zip(res["prompts"], res["tokens"]):
        assert t == oracle(p, C.NEW_TOKENS)


def test_checkpoint_restore(oracle, world2):
    """Checkpoint and restore under the per-rank mirrors: the restored
    engine's tokens equal the serial oracle's; both ranks' files hold the
    same state."""
    res = world2[0]["checkpoint"]
    _same_on_every_rank([r["checkpoint"] for r in world2], "tokens")
    _same_on_every_rank([r["checkpoint"] for r in world2], "ckpt_bytes")
    for p, t in zip(res["prompts"], res["tokens"]):
        assert t == oracle(p, C.NEW_TOKENS)


def test_unified_step(oracle, world2):
    """The unified chunked step on the mesh: decode rows ride the long
    prompt's chunk chain, the fused iterations run as SPMD steps, and the
    tokens equal the serial oracle's."""
    res = world2[0]["unified"]
    _same_on_every_rank([r["unified"] for r in world2], "tokens")
    d = res["counts"]
    assert d.get("unified_iteration_spmd", 0) >= 1, d
    assert d.get("unified_decode_tokens", 0) > 0, d
    assert d.get("unified_prefill_tokens", 0) == sum(
        len(p) for p in res["prompts"]), d
    assert d.get("ring_ppermute", 0) >= 1 and d.get("psum_scatter", 0) >= 1, d
    for p, n, t in zip(res["prompts"], res["new"], res["tokens"]):
        assert t == oracle(p, n)


def test_mesh_guards(world2):
    """With data > 1 an instance count other than data raises; without
    ``mesh=`` the executor builds its mesh over the open world."""
    for res in world2:
        assert res["guards"] == {"instances": True, "default_mesh": True}


def test_cuda_without_cuda_raises(monkeypatch):
    from repro_torch.launch.mesh import init_process_group

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_process_group("cuda")


def test_decode_sampled_breaks_ties_like_the_host(monkeypatch):
    """`Model.decode_sampled` returns the first maximal index, as the
    engine's host `_sample_token` (`np.argmax`) does."""
    from repro_torch.configs import REGISTRY as T_REGISTRY
    from repro_torch.configs import reduced as t_reduced
    from repro_torch.models import build_model

    cfg = t_reduced(T_REGISTRY["lwm-7b"], n_layers=1)
    model = build_model(cfg, device="cpu")
    logits = torch.zeros(4, cfg.vocab_size)
    logits[0, [3, 7]] = 1.0
    logits[1, [9, 2, 200]] = 2.0
    logits[2, :] = -1.0
    logits[3, [255, 0]] = 5.0
    monkeypatch.setattr(model, "decode", lambda p, t, c: (logits, c, None))
    ids, _, _ = model.decode_sampled(None, None, None)
    assert ids.dtype == torch.int32
    assert ids.tolist() == [int(np.argmax(row)) for row in logits.numpy()]
