"""The port's unified continuous-batching iteration against the JAX package.

(i) `core.unified.unified_chunk_attention` (K2 as the per-token prefix
plane over two pool shards, K3 as the carried chunk plane) against the
reference's on the same seeded inputs: prefill chunks, decode rows and a
padding tail, with GQA, a window and a softcap; 2e-5 atol.

(ii) The port's engine with ``ManagerConfig(prefill_chunk_tokens=...)``:
chunk-resume parity for whole / ragged / one-token chunks, decode tokens
flowing while a long prompt is mid-prefill, and the invariant sanitizer
green over a chain with a mid-chain instance failure.  Parameters are the
JAX `Model.init(PRNGKey(0))` pytree converted through numpy; every token
must equal the JAX `serial_decode_oracle` exactly, and the counters must
satisfy the reference tests' assertions (tests/test_unified.py).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.core import unified as JU  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import unified as TU  # noqa: E402
from repro_torch.engine.invariants import InvariantChecker  # noqa: E402
from repro_torch.engine.request import Phase, Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.manager.scheduler import ManagerConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = 2e-5
JCFG = reduced(REGISTRY["lwm-7b"])
TCFG = t_reduced(T_REGISTRY["lwm-7b"])


@pytest.fixture(scope="module")
def models():
    jmodel = j_build_model(JCFG)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(TCFG, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, build_model(TCFG, device="cpu"), params


def _engine(models, n, cap, chunk, **kw):
    _, _, model, params = models
    return LoongServeEngine(TCFG, n, cap, store_values=True, model=model,
                            params=params, device="cpu",
                            mcfg=ManagerConfig(prefill_chunk_tokens=chunk), **kw)


def _oracle(models, prompt, n_decode):
    jmodel, jparams, _, _ = models
    return jref.serial_decode_oracle(jmodel, jparams, prompt, n_decode)


# --------------------------------------------- (i) unified_chunk_attention


def _unified_case(seed, *, h, kvh, d, page, chunks, decodes, pad, window):
    """Seeded operands of one unified layer.  ``chunks``: (prefix, length)
    per prefill segment; ``decodes``: prefix per decode row; each request's
    prefix positions are spread at random over two pool shards (ascending
    within a shard, as `prefix_block_table` requires)."""
    rng = np.random.default_rng(seed)
    segs = [(p, n) for p, n in chunks] + [(p, 1) for p in decodes]
    total = sum(n for _, n in segs)
    t = total + pad
    offsets = np.full(len(segs) + 3, total, np.int32)  # trailing empty segs
    offsets[0] = 0
    offsets[1:len(segs) + 1] = np.cumsum([n for _, n in segs])
    positions = np.zeros(t, np.int32)
    c = 0
    for p, n in segs:
        positions[c:c + n] = np.arange(p, p + n)
        c += n
    shards = []
    owner = [rng.integers(0, 2, p) for p, _ in segs]
    for s in range(2):
        held = [np.nonzero(o == s)[0] for o in owner]  # positions per request
        npg = [-(-len(x) // page) for x in held]
        n_pages = sum(npg) + 3
        perm = rng.permutation(n_pages)
        kp = rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32)
        vp = rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32)
        pos = np.full((n_pages, page), -1, np.int32)
        mp = max(max(npg), 1)
        table = np.zeros((t, mp), np.int32)
        lengths = np.zeros(t, np.int32)
        c = c0 = 0
        for (p, n), x, k in zip(segs, held, npg):
            pages = perm[c0:c0 + k]
            c0 += k
            flat = np.full(k * page, -1, np.int32)
            flat[:len(x)] = x
            pos[pages] = flat.reshape(k, page)
            table[c:c + n, :k] = pages
            lengths[c:c + n] = len(x)
            c += n
        shards.append((kp, vp, table, lengths, pos))
    q = rng.normal(size=(t, h, d)).astype(np.float32)
    k = rng.normal(size=(t, kvh, d)).astype(np.float32)
    v = rng.normal(size=(t, kvh, d)).astype(np.float32)
    return q, k, v, offsets, positions, shards


@pytest.mark.parametrize("h,kvh,page,window,softcap", [
    (4, 4, 1, None, None),
    (4, 2, 4, None, None),
    (4, 2, 1, 9, None),
    (4, 4, 4, 7, 30.0),
    (8, 2, 2, None, 20.0),
])
def test_unified_chunk_attention_matches_reference(h, kvh, page, window, softcap):
    q, k, v, off, pos, shards = _unified_case(
        h * 10 + kvh + page, h=h, kvh=kvh, d=32, page=page,
        chunks=[(0, 11), (13, 6), (40, 9)], decodes=[25, 0, 3, 31, 17],
        pad=7, window=window,
    )
    want = JU.unified_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        jnp.asarray(pos), [tuple(jnp.asarray(x) for x in s) for s in shards],
        window=window, softcap=softcap,
    )
    ops.reset_dispatch_counts()
    got = TU.unified_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), off,
        torch.from_numpy(pos), [tuple(torch.from_numpy(x) for x in s)
                                for s in shards],
        window=window, softcap=softcap,
    )
    # one K2 launch per shard, one K3 launch, nothing else
    assert ops.dispatch_counts == {"paged_decode_partial": 2,
                                   "prefill_ring_chunk": 1}
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert np.isfinite(got.numpy()).all()


def test_unified_attn_impl_cursor_checks_layers():
    """`end_step` refuses a step that consumed fewer layer planes than the
    shards hold; outside a step the impl is the default attention."""
    q, k, v, off, pos, shards = _unified_case(
        3, h=4, kvh=4, d=32, page=1, chunks=[(5, 4)], decodes=[2], pad=2,
        window=None)
    kp, vp, tbl, ln, pp = (torch.from_numpy(x) for x in shards[0])
    shard = TU.UnifiedShard(kp[None].expand(2, *kp.shape).contiguous(),
                            vp[None].expand(2, *vp.shape).contiguous(),
                            None, tbl, ln)
    impl = TU.UnifiedAttnImpl()
    impl.begin_step(off, torch.from_numpy(pos), shards=[shard])
    q4, k4, v4 = (torch.from_numpy(x)[None] for x in (q, k, v))
    out = impl.prefill_attn(q4, k4, v4, None, None, causal=True, window=None,
                            softcap=None)
    assert out.shape == q4.shape
    with pytest.raises(AssertionError):
        impl.end_step()  # one of two planes consumed
    assert not impl._armed


# --------------------------------------------------------- (ii) the engine


def _mixed_requests(rng, n_short=4, short_len=24, short_new=40,
                    long_len=600, long_new=8, long_at=0.05):
    """Short prompts mid-decode when one long prompt arrives whose chunked
    prefill overlaps their instances (the reference test's workload)."""
    reqs = []
    for _ in range(n_short):
        reqs.append(Request(
            input_len=short_len, max_new_tokens=short_new, arrival=0.0,
            prompt=rng.integers(0, TCFG.vocab_size, short_len).tolist(),
        ))
    reqs.append(Request(
        input_len=long_len, max_new_tokens=long_new, arrival=long_at,
        prompt=rng.integers(0, TCFG.vocab_size, long_len).tolist(),
    ))
    return reqs


def test_supports_unified_gate(models):
    """Unified exactly where the reference allows it: dense with the default
    attention and value storage; not without values, not for moe/hybrid."""
    assert _engine(models, 2, 64, 8).executor.supports_unified
    _, _, model, params = models
    sim_vals = LoongServeEngine(TCFG, 2, 64, store_values=False, model=model,
                                params=params, device="cpu")
    assert not sim_vals.executor.supports_unified
    from repro_torch.convert import init_params

    for name in ("mixtral-8x7b", "zamba2-2.7b"):
        cfg = t_reduced(T_REGISTRY[name], n_layers=2 if name != "zamba2-2.7b" else 4)
        m = build_model(cfg, device="cpu")
        p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = LoongServeEngine(cfg, 2, 64, store_values=True, model=m,
                               params=p, device="cpu",
                               mcfg=ManagerConfig(prefill_chunk_tokens=8))
        assert not eng.executor.supports_unified, name


@pytest.mark.parametrize("chunk", [1000, 7, 1])
def test_chunk_resume_parity(models, chunk):
    """Chunk-resume == one-shot prefill for every chunk schedule: the
    engine's tokens equal the JAX serial oracle, and no K1 prefill runs."""
    rng = np.random.default_rng(17)
    reqs = []
    for ln in (13, 21, 5):
        reqs.append(Request(
            input_len=ln, max_new_tokens=4, arrival=0.0,
            prompt=rng.integers(0, TCFG.vocab_size, ln).tolist(),
        ))
    ops.reset_dispatch_counts()
    eng = _engine(models, 2, 2000, chunk)
    for r in reqs:
        eng.submit(r)
    m = eng.run()
    assert len(m.finished) == len(reqs)
    assert ops.dispatch_counts["unified_step"] > 0
    assert ops.dispatch_counts["unified_prefill_tokens"] == sum(
        r.input_len for r in reqs
    )
    assert ops.dispatch_counts.get("prefill_packed", 0) == 0
    assert ops.dispatch_counts.get("prefill_serial_model", 0) == 0
    if chunk == 1:  # one token per chunk -> one iteration per prompt token
        assert ops.dispatch_counts["unified_step"] >= sum(
            r.input_len for r in reqs
        )
    for r in reqs:
        want = _oracle(models, r.prompt, 3)
        assert want == r.output_tokens, (chunk, r.rid, want, r.output_tokens)


def test_decode_flows_during_long_prefill(models):
    """While the long prompt is mid-prefill, fused iterations carry decode
    rows, and every sequence (the long one too) is oracle-exact."""
    rng = np.random.default_rng(19)
    reqs = _mixed_requests(rng)
    eng = _engine(models, 2, 704, 64, page_size=16)
    rs = copy.deepcopy(reqs)
    long_r = rs[-1]
    mix = []
    orig = eng.executor.unified

    def spy(work):
        before = (ops.dispatch_counts["unified_prefill_tokens"],
                  ops.dispatch_counts["unified_decode_tokens"])
        out = orig(work)
        mix.append((
            ops.dispatch_counts["unified_prefill_tokens"] - before[0],
            ops.dispatch_counts["unified_decode_tokens"] - before[1],
            long_r.phase is Phase.PREFILL and long_r.prefill_pos > 0,
        ))
        return out

    eng.executor.unified = spy
    ops.reset_dispatch_counts()
    for r in rs:
        eng.submit(r)
    m = eng.run()
    assert len(m.finished) == len(rs)
    long_iters = [(p, d) for p, d, mid in mix if mid]
    assert len(long_iters) >= 3, mix
    riding = [d for _, d in long_iters if d > 0]
    assert riding, f"no decode tokens flowed during the long prefill: {mix}"
    assert ops.dispatch_counts["unified_decode_tokens"] >= len(riding)
    for r in rs:
        want = _oracle(models, r.prompt, r.max_new_tokens - 1)
        assert want == r.output_tokens, (r.rid, want, r.output_tokens)


def test_invariants_hold_over_unified_chain_with_failure(models):
    """The port's sanitizer (I1-I8, I6 on `unified_done`) stays green after
    every event of a unified-chain run with an instance failure landing
    mid-chain; every request finishes and nothing leaks."""
    rng = np.random.default_rng(23)
    reqs = _mixed_requests(rng, short_new=12, long_len=200, long_new=4)
    eng = _engine(models, 2, 416, 48, page_size=16)
    chk = InvariantChecker(eng)
    chk.arm()
    rs = copy.deepcopy(reqs)
    for r in rs:
        eng.submit(r)
    guard = 0
    while not any(e[2] == "unified_done" for e in eng.events):
        assert eng.events and guard < 500, "no unified chain launched"
        eng.run(max_events=1)
        guard += 1
    work = next(e[3] for e in eng.events if e[2] == "unified_done")
    victim = work.alive_instances(eng.failed)[0]
    eng.fail_instance(victim)
    m = eng.run()
    assert len(m.finished) == len(reqs)
    assert chk.checks > 0
    assert chk.leaked_slots() == 0
    assert eng.pool.total_used == 0
    for orig, r in zip(reqs, rs):
        want = _oracle(models, orig.prompt, orig.max_new_tokens - 1)
        assert want == r.output_tokens, (r.rid, want, r.output_tokens)
