"""The port's kernels (PyTorch plain versions on the CPU) against the JAX
reference: K1 packed prefill, K3 striped ring step, K2 paged decode, K4
position-masked attention, K5 dense-shard decode partial.

The same inputs, made from a seed with numpy, go through the reference's
`repro.kernels.ops` — the Pallas kernel body under ``impl="interpret"`` and
the reference math under ``impl="xla"`` — and through the port's wrappers,
which on CPU tensors run their plain versions.  Tolerance 2e-5 atol on
outputs and partials (DESIGN.md §5).  Cases: {MHA, GQA} x {window} x
{softcap}, ragged offsets with empty segments, a 3/4-point bucket T,
zero-length decode rows, page_size {1, 8}, ring n_shards {2, 4} with carry
chaining equal to K1; K4 {causal, non-causal} and striped / unsorted
positions with Sq != Sk, K5 with k_pos_offset > 0, zero-length rows and
lengths past the shard, and the window convention shared by K4 and K5.
The kernels themselves run on the card (`chip_smoke.py` and
tests/test_torch_kernels_gpu.py).
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import esp as tesp  # noqa: E402
from repro_torch.core import striped as tstriped  # noqa: E402
from hypothesis_compat import given, settings, strategies as st  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_split as tds  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_flash_decode as tpfd  # noqa: E402
from repro_torch.kernels import paged_flash_prefill as tpfp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import striped_attention as tsa  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402

ATOL = 2e-5
H, D = 4, 16
# offsets with empty segments (trailing repeats too) and bucket padding:
# 40 real tokens on a 3/4-point bucket T = 48
OFFSETS = np.array([0, 5, 5, 22, 31, 31, 40, 40], np.int32)
T = 48

# {MHA, GQA} x {window} x {softcap}, under the reference's XLA math and
# under the Pallas kernel body in interpret mode
CASES = [(impl, kvh, w, sc) for impl in ("xla", "interpret")
         for kvh in (4, 2) for w in (None, 7) for sc in (None, 5.0)]


def _qkv(seed, t, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, h, d)).astype(np.float32),
            rng.normal(size=(t, kvh, d)).astype(np.float32),
            rng.normal(size=(t, kvh, d)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _close(got, want, atol=ATOL):
    """allclose on finite entries, and identical -inf/finite pattern."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("impl,kvh,window,softcap", CASES)
def test_packed_prefill_plain_matches_reference(impl, kvh, window, softcap):
    q, k, v = _qkv(0, T, H, kvh, D)
    want = jops.prefill_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(OFFSETS),
        window=window, softcap=softcap, max_seq_len=17, impl=impl,
        block_q=8, block_k=8,
    )
    got = tops.prefill_packed(*_t(q, k, v), OFFSETS, window=window,
                              softcap=softcap)
    n = int(OFFSETS[-1])  # padding rows are their own segment: not compared
    _close(got[:n], np.asarray(want)[:n])


def test_packed_prefill_oracles_agree():
    """The port's dense oracle equals the reference's dense oracle, and the
    padding segment never leaks into real rows of the plain version."""
    q, k, v = _qkv(1, T, H, 2, D)
    want = np.asarray(jref.packed_prefill_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(OFFSETS),
        window=7, softcap=5.0))
    got_ref = tref.packed_prefill_ref(*_t(q, k, v), OFFSETS, window=7,
                                      softcap=5.0)
    got_plain = tpfp.packed_flash_prefill_plain(*_t(q, k, v), OFFSETS,
                                                window=7, softcap=5.0)
    _close(got_ref, want)
    _close(got_plain, want)  # all rows, padding included


def test_cpu_tensor_runs_plain_and_counts_no_launch():
    q, k, v = _qkv(2, 16, H, 2, D)
    tpfp.launch_counts.clear()
    tops.reset_dispatch_counts()
    out = tops.prefill_packed(*_t(q, k, v), np.array([0, 9, 16], np.int32))
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert tops.dispatch_counts["prefill_packed"] == 1
    assert sum(tpfp.launch_counts.values()) == 0


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("impl,kvh,window,softcap", CASES)
def test_ring_chunk_step_matches_reference(impl, kvh, window, softcap):
    """One ring step folded into a non-trivial carry, and the step that
    starts from the empty carry, equal the reference's."""
    n, r = 2, 1
    q, k, v = _qkv(3, T, H, kvh, D)
    offs = [tstriped.shard_offsets(OFFSETS, n, s) for s in range(n)]
    jc, tc = None, None
    for c in (1, 0):  # own chunk, then the rotated one
        args = (q[r::n], k[c::n], v[c::n])
        jc = jops.prefill_ring_chunk(
            *map(jnp.asarray, args), jnp.asarray(offs[r]), jnp.asarray(offs[c]),
            jc, q_shard=r, k_shard=c, n_shards=n, window=window,
            softcap=softcap, max_seq_len=17, impl=impl, block_q=8, block_k=8,
        )
        tc = tops.prefill_ring_chunk(
            *_t(*args), offs[r], offs[c], tc, q_shard=r, k_shard=c,
            n_shards=n, window=window, softcap=softcap,
        )
        for got, want in zip(tc, jc):
            _close(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_prefill_chain_equals_packed(n):
    """The full ring (n steps of carried K3 launches per shard) equals the
    reference's dense packed oracle and the port's single-launch K1."""
    q, k, v = _qkv(4, T, H, 2, D)
    got = tesp.ring_packed_prefill(*_t(q, k, v), OFFSETS, n, window=7,
                                   softcap=5.0)
    want = jref.packed_prefill_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(OFFSETS),
        window=7, softcap=5.0,
    )
    k1 = tops.prefill_packed(*_t(q, k, v), OFFSETS, window=7, softcap=5.0)
    n_real = int(OFFSETS[-1])
    _close(got[:n_real], np.asarray(want)[:n_real])
    _close(got, k1)


def test_shard_offsets_match_reference():
    from repro.core import striped as jstriped

    for n in (2, 3, 4):
        for r in range(n):
            np.testing.assert_array_equal(
                tstriped.shard_offsets(OFFSETS, n, r),
                np.asarray(jstriped.shard_offsets(OFFSETS, n, r)))
        assert tstriped.ring_chunk_schedule(n) == jstriped.ring_chunk_schedule(n)


def test_ring_chunk_oracle_matches_reference():
    n, r, c = 4, 3, 1
    q, k, v = _qkv(5, T, H, 2, D)
    tl = T // n
    carry = (np.zeros((tl, H, D), np.float32),
             np.full((tl, H), -np.inf, np.float32),
             np.zeros((tl, H), np.float32))
    want = jref.packed_prefill_ring_chunk_ref(
        jnp.asarray(q[r::n]), jnp.asarray(k[c::n]), jnp.asarray(v[c::n]),
        jnp.asarray(OFFSETS), tuple(map(jnp.asarray, carry)), q_shard=r,
        k_shard=c, n_shards=n, window=7)
    got = tref.packed_prefill_ring_chunk_ref(
        *_t(q[r::n], k[c::n], v[c::n]), OFFSETS, tuple(_t(*carry)),
        q_shard=r, k_shard=c, n_shards=n, window=7)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


# ------------------------------------------------------------------ K2


def _pool_case(seed, b, page, n_pages, kvh, d):
    """Scattered pages, a zero-length row and a max-length row."""
    rng = np.random.default_rng(seed)
    cap = n_pages * page
    lengths = rng.integers(1, cap // b + 1, b).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = cap // b
    kp = rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32)
    pos = np.full((n_pages, page), -1, np.int32)
    max_pages = int(max(-(-lengths // page)))
    table = np.zeros((b, max_pages), np.int32)
    free = list(rng.permutation(n_pages))
    for i in range(b):
        npg = -(-int(lengths[i]) // page)
        pages = [free.pop() for _ in range(npg)]
        table[i, :npg] = pages
        for j, pg in enumerate(pages):
            pos[pg] = np.arange(j * page, (j + 1) * page)
    q = rng.normal(size=(b, 1, H, d)).astype(np.float32)
    return q, kp, vp, table, lengths, pos


@pytest.mark.parametrize("page", [1, 8])
@pytest.mark.parametrize("impl,kvh,window,softcap", CASES)
def test_paged_decode_plain_matches_reference(page, impl, kvh, window, softcap):
    b = 5
    n_pages = 80 // page
    q, kp, vp, table, lengths, pos = _pool_case(6, b, page, n_pages, kvh, D)
    qpos = lengths.copy()  # query position == cached token count
    want = jops.paged_decode_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), table, lengths,
        pos, query_pos=qpos, window=window, softcap=softcap, impl=impl,
    )
    got = tops.paged_decode_partial(
        *_t(q, kp, vp, table, lengths, pos), query_pos=torch.from_numpy(qpos),
        window=window, softcap=softcap,
    )
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    # zero-length row: the empty partial
    assert torch.isinf(got.m[0]).all() and (got.l[0] == 0).all()
    assert (got.o[0] == 0).all()


def test_paged_decode_empty_table_is_empty_partial():
    q = torch.zeros(3, 1, H, D)
    kp = torch.zeros(4, 1, 2, D)
    p = tpfd.paged_flash_decode_partial(
        q, kp, kp, torch.zeros((3, 0), dtype=torch.int32),
        torch.zeros(3, dtype=torch.int32))
    assert torch.isinf(p.m).all() and (p.l == 0).all() and (p.o == 0).all()


# ------------------------------------------------------------------ K4

# {MHA, GQA} x {causal, non-causal} x {window} x {softcap}
K4_CASES = [(impl, kvh, causal, w, sc) for impl in ("xla", "interpret")
            for kvh in (4, 2)
            for causal, w, sc in [(True, None, None), (False, None, None),
                                  (True, 7, None), (True, None, 5.0),
                                  (False, 7, 5.0)]]


def _bqkv(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, d)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("impl,kvh,causal,window,softcap", K4_CASES)
def test_attention_plain_matches_reference(impl, kvh, causal, window, softcap):
    """Contiguous positions and a striped pair of shards (q shard r = 1 of
    n = 2 against KV shard 0: positions j*n + r)."""
    b, s = 2, 32
    q, k, v = _bqkv(7, b, s, s, H, kvh, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    pos = np.arange(s, dtype=np.int32)
    n = 2
    for qs, ks, qp, kp in [(q, k, pos, pos),
                           (q[:, 1::n], k[:, 0::n], pos[1::n], pos[0::n])]:
        want = jops.attention(*map(jnp.asarray, (qs, ks, v[:, :ks.shape[1]],
                                                 qp, kp)),
                              impl=impl, block_q=8, block_k=8, **kw)
        got = tops.attention(*_t(qs, ks, v[:, :ks.shape[1]], qp, kp), **kw)
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("kvh,causal,window,softcap", [
    (2, True, None, None), (4, False, 9, None), (2, True, 5, 5.0)])
def test_attention_ragged_unsorted_matches_reference(kvh, causal, window,
                                                     softcap):
    """Sq != Sk, neither a block multiple, positions permuted (the kernel
    takes any order): against the reference math (interpret mode needs
    divisible shapes)."""
    q, k, v = _bqkv(8, 2, 13, 29, H, kvh, D)
    rng = np.random.default_rng(9)
    qp = rng.permutation(40)[:13].astype(np.int32)
    kp = rng.permutation(40)[:29].astype(np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jops.attention(*map(jnp.asarray, (q, k, v, qp, kp)), impl="xla",
                          **kw)
    got = tops.attention(*_t(q, k, v, qp, kp), **kw)
    _close(got, want)


def test_attention_oracle_matches_reference_and_counts():
    """The port's K4 oracle equals the reference's; a CPU call is one
    dispatch and no kernel launch."""
    q, k, v = _bqkv(10, 1, 16, 16, H, 2, D)
    pos = np.arange(16, dtype=np.int32)
    want = jref.striped_flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                            pos, pos, window=5, softcap=5.0)
    _close(tref.striped_flash_attention_ref(*_t(q, k, v, pos, pos), window=5,
                                            softcap=5.0), want)
    tsa.launch_counts.clear()
    tops.reset_dispatch_counts()
    tops.attention(*_t(q, k, v, pos, pos))
    assert tops.dispatch_counts["attention"] == 1
    assert sum(tsa.launch_counts.values()) == 0


# ------------------------------------------------------------------ K5

K5_CASES = [(impl, kvh, w, sc, off) for impl in ("xla", "interpret")
            for kvh in (4, 2) for w in (None, 7) for sc in (None, 5.0)
            for off in (0, 24)]


@pytest.mark.parametrize("impl,kvh,window,softcap,offset", K5_CASES)
def test_decode_partial_plain_matches_reference(impl, kvh, window, softcap,
                                                offset):
    """Rows: empty (length 0, or below the shard's offset), inside the
    shard, past the shard's end (a shard of a longer cache), at its end."""
    b, s = 4, 32
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, 1, H, D)).astype(np.float32)
    _, k, v = _bqkv(12, b, 1, s, H, kvh, D)
    lengths = np.array([0, offset + 5, offset + s + 10, offset + s], np.int32)
    kw = dict(k_pos_offset=offset, window=window, softcap=softcap)
    want = jops.decode_partial(*map(jnp.asarray, (q, k, v, lengths)),
                               impl=impl, block_k=8, **kw)
    got = tops.decode_partial(*_t(q, k, v, lengths), **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    assert torch.isinf(got.m[0]).all() and (got.l[0] == 0).all()
    assert (got.o[0] == 0).all()


def test_decode_partial_oracle_matches_reference_and_counts():
    q = np.random.default_rng(13).normal(size=(3, 1, H, D)).astype(np.float32)
    _, k, v = _bqkv(14, 3, 1, 20, H, 2, D)
    lens = np.array([3, 20, 41], np.int32)
    want = jref.flash_decode_partial_ref(*map(jnp.asarray, (q, k, v)), lens,
                                         k_pos_offset=4, window=9)
    got = tref.flash_decode_partial_ref(*_t(q, k, v, lens), k_pos_offset=4,
                                        window=9)
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    tfd.launch_counts.clear()
    tops.reset_dispatch_counts()
    tops.decode_partial(*_t(q, k, v, lens))
    assert tops.dispatch_counts["decode_partial"] == 1
    assert sum(tfd.launch_counts.values()) == 0


@pytest.mark.parametrize("window", [1, 2, 32, 64])
def test_window_convention_parity(window):
    """Mirror of the reference's test: K4's last row at the window edge
    equals K5 over the cache without the query's own token, merged with that
    token's one-key partial — both select the identical window."""
    b, s, kvh = 2, 64, 2
    q, k, v = _bqkv(15, b, s, s, H, kvh, D)
    pos = np.arange(s, dtype=np.int32)
    full = tops.attention(*_t(q, k, v, pos, pos), causal=True, window=window)
    qd = torch.from_numpy(q[:, s - 1:])
    lens = torch.full((b,), s - 1, dtype=torch.int32)
    p_hist = tops.decode_partial(qd, *_t(k[:, :s - 1], v[:, :s - 1]), lens,
                                 window=window)
    p_own = tA.partial_attention(qd, *_t(k[:, s - 1:], v[:, s - 1:]), None)
    last = tA.finalize_partial(tA.merge_partial(p_hist, p_own))[:, 0]
    _close(last, full[:, -1].numpy())
    want = jops.attention(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True,
                          window=window, impl="interpret", block_q=32,
                          block_k=32)
    _close(full, want)


# ------------------------------------------------------------------ build


def test_build_key_covers_included_headers(tmp_path):
    """A library is keyed by its source AND every local header reached
    through quoted includes: editing a header changes the key, so a stale
    library is never loaded; an unrelated file does not."""
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    assert [p.name for p in _build.source_files(src)] == ["a.cuh", "b.cuh",
                                                          "k.cu"]
    key = _build.source_key(src)
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert _build.source_key(src) == key
    (tmp_path / "b.cuh").write_text("int b2;\n")  # nested header edited
    key2 = _build.source_key(src)
    assert key2 != key
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k2;\n')
    assert _build.source_key(src) != key2
    # the shipped attention kernels share csrc/common.cuh; K4 and K1 / K3
    # also share the tensor-core core csrc/attn_tc.cuh, K2 and K5 the
    # split-K decode core csrc/decode_splitk.cuh, both of which include it
    for name, headers in (("striped_attention", ["attn_tc.cuh", "common.cuh"]),
                          ("flash_prefill", ["attn_tc.cuh", "common.cuh"]),
                          ("flash_decode", ["common.cuh", "decode_splitk.cuh"]),
                          ("paged_decode", ["common.cuh", "decode_splitk.cuh"])):
        files = [p.name for p in _build.source_files(_build.CSRC / f"{name}.cu")]
        assert files == headers + [f"{name}.cu"]


_PROTO = re.compile(r"^(int|const char\*)\s+(repro_\w+)\(([^)]*)\)", re.M)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_prototypes_match_ctypes_table(name):
    """Every `extern "C"` entry point of csrc/<name>.cu takes the argument
    kinds (pointer, int, float) that `_build._SIGNATURES` hands ctypes, in
    order, and the table names exactly those entry points: a drift would
    pass garbage to the card, and nothing on the CPU calls the kernels."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    protos = _PROTO.findall(text[text.index('extern "C" {'):])
    table = _build._SIGNATURES[name]
    assert sorted(fn for _, fn, _ in protos) == sorted(table)
    for ret, fn, args in protos:
        kinds = []
        for arg in args.split(","):
            decl = " ".join(arg.split())
            kinds.append(_build._P if "*" in decl else
                         _build._F if decl.startswith("float ") else
                         _build._I if decl.startswith("int ") else decl)
        assert kinds == table[fn], fn
        assert (ret == "const char*") == fn.endswith("_error_string"), fn


# ------------------------------------------------- the bf16 tensor-core route


def _tc_emulation(q, k, v, mask, *, drop_tile=None):
    """Plain-torch emulation of the bf16 tensor-core numerics of K1 / K3 /
    K4 (`csrc/attn_tc.cuh`): f32 Q K^T of bf16 operands, online softmax over
    64-key tiles with the reference's conventions, each tile's P rounded to
    bf16 before P V, l summed from the f32 P.  `drop_tile` skips one tile."""
    sq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    m = torch.full((sq,), -math.inf)
    l = torch.zeros(sq)
    o = torch.zeros(sq, d)
    for i, t0 in enumerate(range(0, k.shape[0], 64)):
        if i == drop_tile:
            continue
        s = torch.where(mask[:, t0:t0 + 64], (q @ k[t0:t0 + 64].T) * scale,
                        torch.tensor(-1e30))
        m_blk = s.max(dim=1).values
        m_new = torch.maximum(m, m_blk)
        m_safe = m_new.clamp_min(-1e29)
        alpha = torch.where(m <= -5e29, torch.zeros(()), torch.exp(m - m_safe))
        p = torch.exp(s - m_safe[:, None])
        l = alpha * l + p.sum(dim=1)
        o = alpha[:, None] * o + p.bfloat16().float() @ v[t0:t0 + 64]
        m = torch.where(m_blk <= -5e29, m, m_new)
    return o / torch.where(l == 0, torch.ones(()), l)[:, None]


def _tc_case(d, seed, s=300):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32))
               .bfloat16().float() for _ in range(3))
    i = torch.arange(s)
    return q, k, v, i[:, None] >= i[None, :]


def _tc_within_bound(got, want, v):
    diff = (got - want).abs()
    return (diff.max().item() <= 1e-4 + 2.0 ** -8 * v.abs().max().item()
            and diff.mean().item() <= 1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_tc_tolerance_holds_for_bf16_rounding_of_p(d, seed):
    """The bound the card's checks use for the bf16 route (max abs err
    <= 1e-4 + 2^-8 max|v|, mean <= 1e-3, against the f32 plain version of
    the same bf16 inputs) holds for the emulated tensor-core numerics."""
    q, k, v, mask = _tc_case(d, seed)
    want = tA.finalize_partial(tA.partial_attention(
        q[None, :, None], k[None, :, None], v[None, :, None], mask[None]))[0, :, 0]
    assert _tc_within_bound(_tc_emulation(q, k, v, mask), want, v)


@pytest.mark.parametrize("fault", ["drop_tile", "shift_diagonal"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_tc_tolerance_catches_a_wrong_kernel(d, fault):
    """The same bound rejects an emulation that skips one key tile or moves
    the causal diagonal by one key: it is tight enough to catch the faults a
    tile walk or a mask can make."""
    q, k, v, mask = _tc_case(d, 0)
    want = tA.finalize_partial(tA.partial_attention(
        q[None, :, None], k[None, :, None], v[None, :, None], mask[None]))[0, :, 0]
    if fault == "drop_tile":
        got = _tc_emulation(q, k, v, mask, drop_tile=2)
    else:
        i = torch.arange(q.shape[0])
        got = _tc_emulation(q, k, v, i[:, None] + 1 >= i[None, :])
    assert not _tc_within_bound(got, want, v)


# ------------------------------------------- the split-K decode core (K2, K5)
#
# csrc/decode_splitk.cuh cuts each row's valid keys [lo, hi) into the
# planner's splits [lo + i * chunk, min(hi, lo + (i + 1) * chunk)), computes
# one partial per split and merges them by log-sum-exp.  No kernel runs on
# the CPU, so these cases hold the design's arithmetic: the plan covers every
# valid key exactly once, and a plain emulation of the split path (per-split
# partials at the planner's boundaries, then the merge as the CUDA merge
# computes it) matches the JAX reference.


def _k5_range(length, s, offset, window):
    """A K5 row's valid keys [lo, hi) in shard coordinates, as DenseRows::
    range in csrc/flash_decode.cu computes them."""
    hi = max(0, min(s, length - offset))
    lo = min(hi, max(0, length - window + 1 - offset)) if window else 0
    return lo, hi


def _split_ranges(lo, hi, n_splits, chunk):
    """The keys each split of one row walks (empty past hi)."""
    return [range(lo + i * chunk, min(hi, lo + (i + 1) * chunk))
            for i in range(n_splits)]


def _near_chunk(data, chunk, long_max):
    """A key count at a split edge (0, 1, chunk - 1, chunk, chunk + 1) or
    anywhere up to ``long_max``."""
    return data.draw(st.one_of(st.sampled_from([0, 1, chunk - 1, chunk,
                                                chunk + 1]),
                               st.integers(0, long_max)))


@settings(max_examples=150, deadline=None)
@given(data=st.data(), b=st.integers(1, 5), kvh=st.sampled_from([1, 2, 8, 32]),
       qpk=st.sampled_from([1, 2, 3, 4, 16]), s=st.integers(1, 5000),
       offset=st.integers(0, 3000),
       window=st.one_of(st.none(), st.integers(1, 6000)),
       n_sm=st.sampled_from([4, 132]))
def test_split_plan_covers_every_dense_key_once(data, b, kvh, qpk, s, offset,
                                                window, n_sm):
    """K5: for any shard length, offset, window and lengths at the split
    edges or past the shard (S < length), the splits of each row walk every
    valid key of the reference's mask exactly once."""
    bound = s if window is None else min(s, window - 1)
    n_splits, chunk = tds.plan(b, kvh, bound, q_per_kv=qpk, n_sm=n_sm)
    assert chunk % tds.TILE == 0 and chunk > 0 and n_splits * chunk >= bound
    for _ in range(b):
        length = offset + _near_chunk(data, chunk, s + 3000)
        pos = offset + np.arange(s)
        valid = pos < length
        if window is not None:
            valid &= pos > length - window
        lo, hi = _k5_range(length, s, offset, window)
        walked = [j for r in _split_ranges(lo, hi, n_splits, chunk) for j in r]
        assert walked == np.flatnonzero(valid).tolist()


@settings(max_examples=150, deadline=None)
@given(data=st.data(), b=st.integers(1, 5), kvh=st.sampled_from([1, 2, 8, 32]),
       qpk=st.sampled_from([1, 2, 4, 16]), page=st.sampled_from([1, 16]),
       max_pages=st.integers(1, 400), n_sm=st.sampled_from([4, 132]))
def test_split_plan_covers_every_paged_key_once(data, b, kvh, qpk, page,
                                                max_pages, n_sm):
    """K2: the splits of each request walk its local tokens [0, lengths[b])
    (clipped to the table's width, as the plain gather is) exactly once; the
    window stays a per-slot test inside the walk."""
    bound = max_pages * page
    n_splits, chunk = tds.plan(b, kvh, bound, q_per_kv=qpk, n_sm=n_sm)
    assert chunk % tds.TILE == 0 and n_splits * chunk >= bound
    for _ in range(b):
        length = _near_chunk(data, chunk, bound + 10)
        hi = min(length, bound)
        walked = [j for r in _split_ranges(0, hi, n_splits, chunk) for j in r]
        assert walked == list(range(hi))


def test_split_plan_fills_the_card():
    """A single row is cut so that its CTAs number about two per SM; a batch
    (rows of unequal lengths) about 16 times that; a batch that brings as
    many CTAs with one split per row keeps one split (pass 1 writes the
    partial itself); the same shapes give the same plan."""
    # the unified step's thousands of short rows, and of long ones
    assert tds.plan(2048, 8, 64, q_per_kv=4) == (1, 64)
    assert tds.plan(2048, 8, 4096, q_per_kv=4) == (1, 4096)
    # K5, B = 1: mixtral's 4095 window keys x 8 KV heads x 2 row blocks in 16
    # splits of four tiles (256 CTAs), zamba2's 8192 x 32 in 8 of 16 tiles
    assert tds.plan(1, 8, 4095, q_per_kv=4) == (16, 256)
    assert tds.plan(1, 32, 8192) == (8, 1024)
    # K2's timed batch: 16 requests x 32 KV heads, up to 4032 keys: 8 splits
    # of 512 keys (4096 CTAs)
    assert tds.plan(16, 32, 4032) == (8, 512)
    for b, kvh, bound, qpk in [(1, 8, 65536, 4), (3, 2, 700, 1), (4, 8, 4096, 16),
                               (1, 1, 10, 1), (7, 32, 300, 1), (16, 32, 4032, 1)]:
        n, chunk = tds.plan(b, kvh, bound, q_per_kv=qpk)
        ctas = b * kvh * -(-qpk // tds.rows_per_cta(qpk))
        tiles = -(-bound // tds.TILE)
        target = tds.CTAS_PER_SM * tds.H100_SMS * (tds.RAGGED if b > 1 else 1)
        if n > 1:  # about the target (or one tile per split, short of it)
            assert min(target / 2, ctas * tiles) <= n * ctas <= 2 * target + ctas
        assert (n - 1) * chunk < bound <= n * chunk
        assert tds.plan(b, kvh, bound, q_per_kv=qpk) == (n, chunk)
    assert [tds.rows_per_cta(g) for g in (1, 2, 3, 4, 16)] == [1, 2, 2, 2, 2]


def _merge_splits(parts, warps=8):
    """The merge pass of csrc/decode_splitk.cuh in plain torch, as it
    computes it: warp w folds splits w, w + warps, ... by an online
    log-sum-exp (empty splits skipped), then the warps' states are folded:
    m = max_w m_w, a_w = exp(m_w - max(m, -1e29)), l = sum a_w l_w,
    o = sum a_w o_w; all splits empty gives m = -inf, l = 0, o = 0."""
    states = []
    for w in range(warps):
        mw = torch.full_like(parts[0].m, -math.inf)
        lw = torch.zeros_like(parts[0].l)
        ow = torch.zeros_like(parts[0].o)
        for p in parts[w::warps]:
            live = torch.isfinite(p.m)
            mn = torch.where(live, torch.maximum(mw, p.m), mw)
            a = torch.where(live, torch.exp(mw - mn), torch.ones(()))
            wt = torch.where(live, torch.exp(p.m - mn), torch.zeros(()))
            lw = lw * a + wt * p.l
            ow = ow * a[..., None] + wt[..., None] * p.o
            mw = mn
        states.append((mw, lw, ow))
    mx = torch.stack([s[0] for s in states]).amax(dim=0)
    ms = mx.clamp_min(-1e29)
    wts = [torch.exp(s[0] - ms) for s in states]
    return tA.Partial(o=sum(a[..., None] * s[2] for a, s in zip(wts, states)),
                      m=torch.where(torch.isinf(mx), mx, ms),
                      l=sum(a * s[1] for a, s in zip(wts, states)))


def _close_split(got, want):
    """The module's tolerances for partials: o / l and m within 2e-5, l
    relative 1e-4, the same empty rows."""
    wo, wm, wl = (np.asarray(x) for x in want)
    _close(got.m, wm)
    np.testing.assert_allclose(got.l.numpy(), wl, rtol=1e-4, atol=0)
    den = np.where(wl == 0, 1.0, wl)[..., None]
    _close(got.o / torch.where(got.l == 0, torch.ones(()), got.l)[..., None],
           wo / den)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("kvh,window,softcap", [(2, None, None), (2, 100, None),
                                                (4, 150, 5.0), (1, None, 5.0)])
def test_split_emulation_matches_reference_dense(impl, kvh, window, softcap):
    """K5's split path at the planner's boundaries (320 keys, offset 24):
    rows empty, ending at chunk - 1 / chunk / chunk + 1 keys, past the
    shard; windows that leave whole splits empty."""
    b, s, off = 5, 320, 24
    rng = np.random.default_rng(21)
    q = rng.normal(size=(b, 1, H, D)).astype(np.float32)
    _, k, v = _bqkv(22, b, 1, s, H, kvh, D)
    bound = s if window is None else min(s, window - 1)
    n_splits, chunk = tds.plan(b, kvh, bound, q_per_kv=H // kvh)
    assert n_splits > 1
    lengths = np.array([0, off + chunk - 1, off + chunk, off + chunk + 1,
                        off + s + 10], np.int32)
    tq, tk, tv = _t(q, k, v)
    parts = []
    for i in range(n_splits):
        mask = torch.zeros(b, 1, s, dtype=torch.bool)
        for r in range(b):
            keys = _split_ranges(*_k5_range(int(lengths[r]), s, off, window),
                                 n_splits, chunk)[i]
            mask[r, 0, keys.start:keys.stop] = len(keys) > 0
        parts.append(tA.partial_attention(tq, tk, tv, mask, softcap=softcap))
    got = _merge_splits(parts)
    want = jops.decode_partial(*map(jnp.asarray, (q, k, v, lengths)), impl=impl,
                               block_k=64, k_pos_offset=off, window=window,
                               softcap=softcap)
    _close_split(got, want)
    assert torch.isinf(got.m[0]).all() and (got.l[0] == 0).all()
    assert (got.o[0] == 0).all()


@pytest.mark.parametrize("impl,page", [("xla", 1), ("xla", 16), ("interpret", 16)])
@pytest.mark.parametrize("kvh,window,softcap", [(2, None, None), (2, 40, None),
                                                (4, 100, 5.0)])
def test_split_emulation_matches_reference_paged(impl, page, kvh, window,
                                                 softcap):
    """K2's split path at the planner's boundaries over scattered pages:
    rows empty, ending at chunk - 1 / chunk / chunk + 1 tokens, full; the
    per-slot window leaves the first splits of long rows all masked."""
    b, s = 5, 320  # the table's width in tokens; the pool holds 640 slots
    n_pages, max_pages = 640 // page, s // page
    rng = np.random.default_rng(23)
    q = rng.normal(size=(b, 1, H, D)).astype(np.float32)
    kp = rng.normal(size=(n_pages, page, kvh, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, kvh, D)).astype(np.float32)
    n_splits, chunk = tds.plan(b, kvh, s, q_per_kv=H // kvh)
    assert n_splits > 1
    lengths = np.array([0, chunk - 1, chunk, chunk + 1, s], np.int32)
    table = np.zeros((b, max_pages), np.int32)
    pos = np.full((n_pages, page), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for i in range(b):
        pages = [free.pop() for _ in range(-(-int(lengths[i]) // page))]
        table[i, :len(pages)] = pages
        for j, pg in enumerate(pages):
            pos[pg] = np.arange(j * page, (j + 1) * page)
    qpos = lengths.copy()
    tq, tkp, tvp = _t(q, kp, vp)
    flat = torch.from_numpy(table.reshape(-1)).long()
    k = tkp[flat].reshape(b, s, kvh, D)
    v = tvp[flat].reshape(b, s, kvh, D)
    kpos = torch.from_numpy(pos)[flat].reshape(b, s)
    parts = []
    for i in range(n_splits):
        mask = torch.zeros(b, 1, s, dtype=torch.bool)
        for r in range(b):
            keys = _split_ranges(0, min(int(lengths[r]), s), n_splits, chunk)[i]
            mask[r, 0, keys.start:keys.stop] = len(keys) > 0
        if window is not None:
            mask &= (torch.from_numpy(qpos)[:, None, None] - kpos[:, None]) < window
        parts.append(tA.partial_attention(tq, k, v, mask, softcap=softcap))
    got = _merge_splits(parts)
    want = jops.paged_decode_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), table, lengths, pos,
        query_pos=qpos, window=window, softcap=softcap, impl=impl,
    )
    _close_split(got, want)
    assert torch.isinf(got.m[0]).all() and (got.l[0] == 0).all()
    assert (got.o[0] == 0).all()
