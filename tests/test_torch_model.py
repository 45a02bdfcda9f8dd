"""The port's dense model against the JAX reference on reduced configs,
with one parameter set converted from the JAX `Model.init` pytree.

Configs: lwm-7b (MHA), glm4-9b (GQA, partial RoPE), qwen1.5-4b (qkv bias)
and h2o-danube-1.8b (sliding window, narrowed so short prompts reach it).
Checked: the dense `prefill` logits and KV cache, the packed `prefill_packed`
path (K1 at DoP=1, the striped K3 ring at DoP=2) logits and per-layer KV,
dense-cache `decode`, and multi-master paged `decode` over two pool shards
(K2).  Hidden states and logits: 1e-4 atol in f32 (the summation order
differs between frameworks).  Biases and norm scales are perturbed away
from their zero/one init so they are exercised.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.core.paged_decode import PagedDecodeAttnImpl as JPaged  # noqa: E402
from repro.core.paged_decode import PagedShard as JShard  # noqa: E402
from repro.core.paged_prefill import PackedPrefillAttnImpl as JPacked  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.transformer import Cache as JCache  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.paged_decode import PagedDecodeAttnImpl as TPaged  # noqa: E402
from repro_torch.core.paged_decode import PagedShard as TShard  # noqa: E402
from repro_torch.core.paged_prefill import PackedPrefillAttnImpl as TPacked  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.transformer import Cache as TCache  # noqa: E402

ATOL = 1e-4
ARCHS = {
    "lwm-7b": {},
    "glm4-9b": {},
    "qwen1.5-4b": {},
    "h2o-danube-1.8b": {"sliding_window": 6},
}


def _pair(arch):
    over = dict(n_layers=2, **ARCHS[arch])
    jcfg = reduced(REGISTRY[arch], **over)
    tcfg = t_reduced(T_REGISTRY[arch], **over)
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lay = tree["layers"]
    for k in ("bq", "bk", "bv"):
        if k in lay["attn"]:
            lay["attn"][k] = rng.normal(size=lay["attn"][k].shape).astype(np.float32) * 0.1
    for n in ("norm1", "norm2"):
        lay[n]["scale"] = (1 + 0.1 * rng.normal(size=lay[n]["scale"].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree, device="cpu")
    return j_build(jcfg), jparams, t_build(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    return _pair(request.param)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_dense_prefill_and_decode(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 11))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), atol=ATOL)
    # one dense-cache decode step from the prefilled cache
    nxt = rng.integers(0, jm.cfg.vocab_size, 2)
    jl, jcache, jkv = jm.decode(jp, jnp.asarray(nxt), JCache(
        k=jc.k, v=jc.v, length=jnp.asarray([11, 9], jnp.int32)))
    tl, tcache, tkv = tm.decode(tp, torch.from_numpy(nxt), TCache(
        k=tc.k, v=tc.v, length=torch.tensor([11, 9], dtype=torch.int32)))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(_np(tkv[0]), np.asarray(jkv[0]), atol=ATOL)
    np.testing.assert_array_equal(_np(tcache.length), [12, 10])


@pytest.mark.parametrize("dop", [1, 2])
def test_prefill_packed_logits_and_kv(pair, dop):
    """The packed step (K1 at dop=1, the striped K3 ring at dop=2) against
    the reference's packed step under its XLA path, on a ragged batch with
    a bucket-padded token axis and an empty trailing segment."""
    jm, jp, tm, tp = pair
    lens = [9, 3, 14]
    total, tb, bb = sum(lens), 32, 4
    rng = np.random.default_rng(2)
    tokens = np.zeros(tb, np.int32)
    positions = np.zeros(tb, np.int32)
    offsets = np.full(bb + 1, total, np.int32)
    offsets[0] = 0
    last = np.zeros(bb, np.int32)
    c = 0
    for b, n in enumerate(lens):
        tokens[c:c + n] = rng.integers(0, jm.cfg.vocab_size, n)
        positions[c:c + n] = np.arange(n)
        c += n
        offsets[b + 1] = c
        last[b] = c - 1
    ji, ti = JPacked(impl="xla"), TPacked()
    jm.attn_impl, tm.attn_impl = ji, ti
    ji.begin_step(jnp.asarray(offsets), 16, dop=dop)
    ti.begin_step(offsets, dop=dop)
    try:
        jl, (jk, jv) = jm.prefill_packed(
            jp, {"tokens": jnp.asarray(tokens)[None]}, jnp.asarray(positions),
            jnp.asarray(last))
        tl, (tk, tv) = tm.prefill_packed(
            tp, {"tokens": torch.from_numpy(tokens.astype(np.int64))[None]},
            torch.from_numpy(positions.astype(np.int64)),
            torch.from_numpy(last.astype(np.int64)))
    finally:
        ji.end_step()
        ti.end_step()
    np.testing.assert_allclose(_np(tl)[:len(lens)], np.asarray(jl)[:len(lens)],
                               atol=ATOL)
    np.testing.assert_allclose(_np(tk)[:, :total], np.asarray(jk)[:, :total],
                               atol=ATOL)
    np.testing.assert_allclose(_np(tv)[:, :total], np.asarray(jv)[:, :total],
                               atol=ATOL)


def test_paged_decode_two_shards(pair):
    """Multi-master paged decode: one K2 launch per shard per layer, LSE
    merge with the new token's KV, against the reference's per-shard loop
    (XLA path) over the same two pool shards."""
    jm, jp, tm, tp = pair
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    page, n_pages, b = 4, 12, 3
    L, kvh, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    lengths_total = np.array([7, 13, 10], np.int32)
    shards_np = []
    for s in range(2):  # shard s holds positions p with p % 2 == s
        kp = rng.normal(size=(L, n_pages, page, kvh, d)).astype(np.float32) * 0.5
        vp = rng.normal(size=(L, n_pages, page, kvh, d)).astype(np.float32) * 0.5
        pos = np.full((n_pages, page), -1, np.int32)
        lens = np.array([(n - s + 1) // 2 for n in lengths_total], np.int32)
        table = np.zeros((b, 2), np.int32)
        free = list(rng.permutation(n_pages))
        for i in range(b):
            npg = -(-int(lens[i]) // page)
            pages = [free.pop() for _ in range(npg)]
            table[i, :npg] = pages
            gpos = np.arange(s, lengths_total[i], 2)
            for j, pg in enumerate(pages):
                chunk = gpos[j * page:(j + 1) * page]
                pos[pg, :len(chunk)] = chunk
        shards_np.append((kp, vp, table, lens, pos))
    win = cfg.sliding_window is not None
    jsh = [JShard(*(jnp.asarray(x) for x in s[:4]),
                  pos=jnp.asarray(s[4]) if win else None) for s in shards_np]
    tsh = [TShard(*(torch.from_numpy(x) for x in s[:4]),
                  pos=torch.from_numpy(s[4]) if win else None) for s in shards_np]
    toks = rng.integers(0, cfg.vocab_size, b)
    ji, ti = JPaged(impl="xla"), TPaged()
    jm.attn_impl, tm.attn_impl = ji, ti
    ji.begin_step(jsh)
    ti.begin_step(tsh)
    try:
        jl, _, jkv = jm.decode(jp, jnp.asarray(toks), JCache(
            length=jnp.asarray(lengths_total)))
        tl, _, tkv = tm.decode(tp, torch.from_numpy(toks), TCache(
            length=torch.from_numpy(lengths_total)))
    finally:
        ji.end_step()
        ti.end_step()
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(_np(tkv[1]), np.asarray(jkv[1]), atol=ATOL)
