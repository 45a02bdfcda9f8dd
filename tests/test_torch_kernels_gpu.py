"""The port's CUDA kernels (K1, K3, K2, K4, K5) against their plain PyTorch
versions on a CUDA device.  Marked ``gpu``: they skip where no CUDA device exists.
They import no JAX, so they run on a machine with only PyTorch::

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py

Tolerances.  f32 operands (the fp32-FMA bodies, and K2 / K5 in either
type): 2e-5 atol on normalized outputs and partials at these small shapes —
the same f32 math in another order.  bf16 operands of K1, K3 and K4 run on
the tensor cores (`csrc/attn_tc.cuh`): Q K^T of bf16 operands accumulates
exactly in f32, but each softmax weight is rounded to bf16 once before P V,
which costs at most 2^-9 of it, so the normalized output may move by
2^-9 max|v|; the bound is 1e-4 + 2^-8 max|v| (the factor 2 covers the
rescale by alpha), and the mean error must stay below 1e-3.  K4 writes bf16
outputs, so they may also sit one bf16 step apart (2^-7 |plain|).  m keeps
1e-4 absolute, l 1e-4 relative, and empty rows must match.  The split-K
decode cases (long rows, many rows) hold o / l and m to 1e-4: f32 sums over
up to 64k keys in another order, merged across splits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import striped as tstriped  # noqa: E402
from repro_torch.kernels import decode_split as tds  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import paged_flash_decode as tpfd  # noqa: E402
from repro_torch.kernels import paged_flash_prefill as tpfp  # noqa: E402
from repro_torch.kernels import striped_attention as tsa  # noqa: E402

ATOL = 2e-5
H, D = 4, 16
OFFSETS = np.array([0, 5, 5, 22, 31, 31, 40, 40], np.int32)
T = 48


def _qkv(seed, t, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, h, d)).astype(np.float32),
            rng.normal(size=(t, kvh, d)).astype(np.float32),
            rng.normal(size=(t, kvh, d)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _close(got, want, atol=ATOL):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol)


def _close_tc(got, want, v, bf16_out=False):
    """The bf16 tensor-core route: the output within 1e-4 + 2^-8 max|v|
    (plus 2^-7 |plain| for a bf16 output), mean error below 1e-3."""
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    diff = (got - want).abs()
    tol = 1e-4 + 2.0 ** -8 * v.float().abs().max().item()
    bound = tol + (2.0 ** -7 * want.abs() if bf16_out else 0.0)
    assert bool((diff <= bound).all()), (diff.max().item(), tol)
    assert diff.mean().item() <= 1e-3, diff.mean().item()


def _close_partial_tc(got, want, v):
    """Carried (o, m, l) on the tensor-core route: o / l as `_close_tc`, m
    1e-4 absolute, l 1e-4 relative, the same empty rows."""
    (o, m, l), (wo, wm, wl) = got, want
    fin = torch.isfinite(wm)
    assert torch.equal(torch.isfinite(m), fin)
    assert (m[fin] - wm[fin]).abs().max().item() <= 1e-4 if fin.any() else True
    assert ((l - wl).abs() <= 1e-4 * wl.abs()).all()

    def fin_o(o_, l_):
        return o_ / torch.where(l_ == 0, torch.ones_like(l_), l_)[..., None]

    _close_tc(fin_o(o, l), fin_o(wo, wl), v)


def _pool_case(seed, b, page, n_pages, kvh, d):
    rng = np.random.default_rng(seed)
    cap = n_pages * page
    lengths = rng.integers(1, cap // b + 1, b).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = cap // b
    kp = rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32)
    pos = np.full((n_pages, page), -1, np.int32)
    table = np.zeros((b, int(max(-(-lengths // page)))), np.int32)
    free = list(rng.permutation(n_pages))
    for i in range(b):
        npg = -(-int(lengths[i]) // page)
        pages = [free.pop() for _ in range(npg)]
        table[i, :npg] = pages
        for j, pg in enumerate(pages):
            pos[pg] = np.arange(j * page, (j + 1) * page)
    q = rng.normal(size=(b, 1, H, d)).astype(np.float32)
    return q, kp, vp, table, lengths, pos


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh,window,softcap", [(4, None, None), (2, 7, 5.0)])
def test_kernels_match_plain_on_card(cuda_device, dtype, kvh, window, softcap):
    """K1, K3 and K2 on CUDA tensors against their plain versions on the
    same inputs (f32 2e-5; bf16 K1 / K3 run on the tensor cores: the
    module's bf16 bound; bf16 K2 widens to f32 in both: 2e-5)."""
    dt = getattr(torch, dtype)
    tc = dt == torch.bfloat16
    q, k, v = (x.to(cuda_device, dt) for x in _t(*_qkv(7, T, H, kvh, D)))
    got = tpfp.packed_flash_prefill(q, k, v, OFFSETS, window=window,
                                    softcap=softcap)
    want = tpfp.packed_flash_prefill_plain(q, k, v, OFFSETS, window=window,
                                           softcap=softcap)
    _close_tc(got, want, v) if tc else _close(got, want)
    n = 2
    offs = [tstriped.shard_offsets(OFFSETS, n, s) for s in range(n)]
    carry = None
    for c in (1, 0):
        kw = dict(q_shard=1, k_shard=c, n_shards=n, window=window,
                  softcap=softcap)
        got = tpfp.packed_flash_prefill_ring_chunk(
            q[1::n], k[c::n], v[c::n], offs[1], offs[c], carry, **kw)
        want = tpfp.packed_flash_prefill_ring_chunk_plain(
            q[1::n], k[c::n], v[c::n], offs[1], offs[c], carry, **kw)
        if tc:
            _close_partial_tc(got, want, v)
        else:
            for g_, w_ in zip(got, want):
                _close(g_, w_)
        carry = got
    for page in (1, 8):
        qd, kp, vp, table, lengths, pos = _pool_case(8, 5, page, 80 // page,
                                                     kvh, D)
        args = [x.to(cuda_device) for x in _t(qd, kp, vp, table, lengths, pos)]
        args[0], args[1], args[2] = (x.to(dt) for x in args[:3])
        got = tpfd.paged_flash_decode_partial(
            *args, query_pos=args[4], window=window, softcap=softcap)
        want = tpfd.paged_flash_decode_partial_plain(
            *args, query_pos=args[4], window=window, softcap=softcap)
        for g_, w_ in zip(got, want):
            _close(g_, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh,d", [(4, 2, 16), (4, 4, 80)])
@pytest.mark.parametrize("causal,window,softcap", [(True, None, None),
                                                   (False, 7, 5.0)])
def test_attention_kernels_match_plain_on_card(cuda_device, dtype, h, kvh, d,
                                               causal, window, softcap):
    """K4 (ragged Sq != Sk, striped and unsorted positions, B = 2) and K5
    (k_pos_offset > 0, an empty row, a row past the shard) on CUDA tensors
    against their plain versions."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(9)
    b, sq, sk = 2, 37, 70

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, dt)

    q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    for qp, kp in [(np.arange(sq) * 2 + 1, np.arange(sk) * 2),
                   (rng.permutation(sk)[:sq], rng.permutation(sk))]:
        qp, kp = (torch.as_tensor(x, dtype=torch.int32, device=cuda_device)
                  for x in (qp, kp))
        got = tsa.striped_flash_attention(q, k, v, qp, kp, **kw)
        want = tsa.striped_flash_attention_plain(q, k, v, qp, kp, **kw)
        assert got.dtype == dt
        if dt == torch.float32:
            _close(got, want)
        else:  # tensor cores, and a bf16 output one bf16 step apart at most
            _close_tc(got, want, v, bf16_out=True)
    qd = rand(4, 1, h, d)
    kd, vd = rand(4, sk, kvh, d), rand(4, sk, kvh, d)
    off = 9
    lens = torch.tensor([0, off + 20, off + sk + 5, off + sk], dtype=torch.int32,
                        device=cuda_device)
    dkw = dict(k_pos_offset=off, window=window, softcap=softcap)
    got = tfd.flash_decode_partial(qd, kd, vd, lens, **dkw)
    want = tfd.flash_decode_partial_plain(qd, kd, vd, lens, **dkw)
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    assert torch.isinf(got.m[0]).all() and (got.l[0] == 0).all()


# (D, q_per_kv, Sq, Sk): ragged tile edges (not multiples of 64) at the head
# sizes of the served models (80: zamba2) and GQA groups that do not divide
# the rows of a CTA (3) or fill a CTA with few tokens (16); D = 96 runs the
# bf16 head-size template 128 zero-padded, D = 256 the widest one
EDGE_CASES = [(64, 1, 70, 70), (80, 3, 131, 131), (128, 4, 100, 257),
              (128, 16, 45, 45), (80, 1, 257, 190), (96, 4, 70, 70),
              (256, 2, 70, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,qpk,sq,sk", EDGE_CASES)
def test_attention_tile_edges_on_card(cuda_device, dtype, d, qpk, sq, sk):
    """K4, K1 and K3 where tiles are ragged: Sq, Sk not multiples of 64
    (K4 queries at the last Sq positions), a window edge inside a key tile
    (window 37), segment edges inside key tiles (K1 / K3), GQA groups of 1,
    3, 4 and 16; a full ring of 3 shards for K3."""
    dt = getattr(torch, dtype)
    tc = dt == torch.bfloat16
    kvh = 2
    h = kvh * qpk
    rng = np.random.default_rng(d * 1000 + qpk)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, dt)

    def check(got, want, v):
        _close_tc(got, want, v, bf16_out=tc and got.dtype == dt) if tc else \
            _close(got, want)

    q, k, v = rand(1, sq, h, d), rand(1, sk, kvh, d), rand(1, sk, kvh, d)
    qp = torch.arange(max(sk - sq, 0), max(sk - sq, 0) + sq, dtype=torch.int32,
                      device=cuda_device)
    kp = torch.arange(sk, dtype=torch.int32, device=cuda_device)
    for causal, window, softcap in [(True, None, None), (True, 37, None),
                                    (False, None, 20.0)]:
        kw = dict(causal=causal, window=window, softcap=softcap)
        check(tsa.striped_flash_attention(q, k, v, qp, kp, **kw),
              tsa.striped_flash_attention_plain(q, k, v, qp, kp, **kw), v)
    # K1 over a packed batch of 3 * 64 + 9 tokens with segment edges inside
    # key tiles and an empty segment
    t = 3 * 64 + 9
    off = np.array([0, 13, 13, 77, t - 40, t - 3], np.int32)
    q1, k1, v1 = rand(t, h, d), rand(t, kvh, d), rand(t, kvh, d)
    for window in (None, 37):
        check(tpfp.packed_flash_prefill(q1, k1, v1, off, window=window),
              tpfp.packed_flash_prefill_plain(q1, k1, v1, off, window=window),
              v1)
    # K3: a full ring over n = 3 shards (t divisible by 3), every step
    # against the plain step on the same carry
    n = 3
    offs = [tstriped.shard_offsets(off, n, r) for r in range(n)]
    for r in range(n):
        carry = None
        for step in range(n):
            c = tstriped.ring_chunk_schedule(n)[step][r]
            args = (q1[r::n].contiguous(), k1[c::n].contiguous(),
                    v1[c::n].contiguous(), offs[r], offs[c])
            kw = dict(q_shard=r, k_shard=c, n_shards=n, window=37)
            got = tpfp.packed_flash_prefill_ring_chunk(*args, carry, **kw)
            want = tpfp.packed_flash_prefill_ring_chunk_plain(*args, carry, **kw)
            if tc:
                _close_partial_tc(got, want, v1)
            else:
                for g_, w_ in zip(got, want):
                    _close(g_, w_)
            carry = want


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 100_000])
def test_striped_attention_long_keys_on_card(cuda_device, window):
    """K4 on bf16 over 150k keys (2344 key tiles): the per-CTA visit bitmaps
    are sized from Sk, so the last queries still see every key they may."""
    rng = np.random.default_rng(11)
    sq, sk, d = 40, 150_000, 64

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)

    q, k, v = rand(1, sq, 2, d), rand(1, sk, 1, d), rand(1, sk, 1, d)
    qp = torch.arange(sk - sq, sk, dtype=torch.int32, device=cuda_device)
    kp = torch.arange(sk, dtype=torch.int32, device=cuda_device)
    kw = dict(causal=True, window=window)
    _close_tc(tsa.striped_flash_attention(q, k, v, qp, kp, **kw),
              tsa.striped_flash_attention_plain(q, k, v, qp, kp, **kw), v,
              bf16_out=True)


# ------------------------------------------- the split-K decode core (K2, K5)


def _close_partial(got, want, atol=1e-4):
    """(o, m, l) of the split-K decode core against the plain partial: o / l
    and m within ``atol`` (f32 sums over up to 64k keys in another order and
    merged across splits), l relative 1e-4, the same empty rows."""
    (o, m, l), (wo, wm, wl) = (tuple(x.float().cpu() for x in p) for p in (got, want))
    fin = torch.isfinite(wm)
    assert torch.equal(torch.isfinite(m), fin)
    if fin.any():
        assert (m[fin] - wm[fin]).abs().max().item() <= atol
    assert ((l - wl).abs() <= 1e-4 * wl.abs()).all(), (l - wl).abs().max().item()

    def fin_o(o_, l_):
        return o_ / torch.where(l_ == 0, torch.ones_like(l_), l_)[..., None]

    diff = (fin_o(o, l) - fin_o(wo, wl)).abs().max().item()
    assert diff <= atol, diff
    empty = ~fin
    assert (l[empty] == 0).all() and (o[empty] == 0).all()


def _paged_pool(rng, lengths, page, kvh, d, dt, dev, width=None, spare=8):
    """A pool with every request on scattered pages, its block table (at
    least ``width`` pages wide) and the pages' global positions."""
    npg = [-(-int(x) // page) for x in lengths]
    n_pages = sum(npg) + spare
    kp = torch.from_numpy(rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(n_pages, page, kvh, d)).astype(np.float32))
    table = np.zeros((len(lengths), max(max(npg), width or 1)), np.int32)
    pos = np.full((n_pages, page), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for i, n in enumerate(npg):
        pages = [free.pop() for _ in range(n)]
        table[i, :n] = pages
        for j, pg in enumerate(pages):
            pos[pg] = np.arange(j * page, (j + 1) * page)
    as_dev = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (kp.to(dev, dt), vp.to(dev, dt), as_dev(table),
            as_dev(np.asarray(lengths, np.int32)), as_dev(pos))


DTYPE_PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
               ("float32", "bfloat16"), ("bfloat16", "bfloat16")]


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,kvdt", DTYPE_PAIRS)
@pytest.mark.parametrize("d", [16, 80, 96, 128, 256])
def test_split_decode_edges_on_card(cuda_device, qdt, kvdt, d):
    """K2 (page sizes 1 and 16, with and without a window over page_pos) and
    K5 (k_pos_offset > 0, with and without a window, a softcap) where rows
    end at chunk - 1, chunk and chunk + 1 keys of the wrapper's plan, an
    empty row and a full one; two plans: 64-key splits (B 5, KVH 2) and
    512-key splits (B 4, KVH 8, 4096 keys)."""
    q_dt, kv_dt = getattr(torch, qdt), getattr(torch, kvdt)
    rng = np.random.default_rng(d)
    n_sm = tds.sm_count(cuda_device)

    def rand(*shape, dt):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, dt)

    for b, kvh, qpk, s in [(5, 2, 2, 1024), (4, 8, 1, 4096)]:
        h = kvh * qpk
        n_splits, chunk = tds.plan(b, kvh, s, q_per_kv=qpk, n_sm=n_sm)
        assert n_splits > 1
        edges = [chunk - 1, chunk, chunk + 1, 0, s][:b]
        q = rand(b, 1, h, d, dt=q_dt)
        # K2: the request lengths at the edges, the table s tokens wide
        for page in (1, 16):
            kp, vp, bt, ln, pos = _paged_pool(rng, edges, page, kvh, d, kv_dt,
                                              cuda_device, width=s // page)
            assert bt.shape[1] * page == s
            for window, softcap in [(None, None), (300, 20.0)]:
                kw = dict(query_pos=ln, window=window, softcap=softcap)
                _close_partial(
                    tpfd.paged_flash_decode_partial(q, kp, vp, bt, ln, pos, **kw),
                    tpfd.paged_flash_decode_partial_plain(q, kp, vp, bt, ln, pos, **kw))
        # K5: the valid keys at the edges behind an offset
        off = 24
        k, v = rand(b, s, kvh, d, dt=kv_dt), rand(b, s, kvh, d, dt=kv_dt)
        ln = torch.tensor([off + x for x in edges], dtype=torch.int32,
                          device=cuda_device)
        for window, softcap in [(None, None), (chunk + 1, 20.0)]:
            kw = dict(k_pos_offset=off, window=window, softcap=softcap)
            got = tfd.flash_decode_partial(q, k, v, ln, **kw)
            _close_partial(got, tfd.flash_decode_partial_plain(q, k, v, ln, **kw))
            assert torch.isinf(got.m[3]).all() and (got.l[3] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 5000])
def test_split_decode_long_row_on_card(cuda_device, window):
    """B = 1 over 64k keys at KVH 8 (mixtral's GQA 4, D 128, bf16): K5 over a
    dense shard and K2 over 16-token pages; with a window only its keys
    count."""
    rng = np.random.default_rng(31)
    s, kvh, h, d = 65536, 8, 32, 128
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, bf16)

    q, k, v = rand(1, 1, h, d), rand(1, s, kvh, d), rand(1, s, kvh, d)
    ln = torch.tensor([s], dtype=torch.int32, device=cuda_device)
    kw = dict(window=window)
    _close_partial(tfd.flash_decode_partial(q, k, v, ln, **kw),
                   tfd.flash_decode_partial_plain(q, k, v, ln, **kw))
    kp, vp, bt, ln, pos = _paged_pool(rng, [s], 16, kvh, d, bf16, cuda_device)
    kw = dict(query_pos=ln, window=window)
    _close_partial(tpfd.paged_flash_decode_partial(q, kp, vp, bt, ln, pos, **kw),
                   tpfd.paged_flash_decode_partial_plain(q, kp, vp, bt, ln, pos, **kw))


@pytest.mark.gpu
def test_split_decode_many_rows_on_card(cuda_device):
    """2048 rows of short contexts (the unified step's prefix plane): one
    split per row, pass 1 writing (o, m, l) itself; K2 on the f32 pool with
    bf16 q at page size 1, and K5."""
    rng = np.random.default_rng(32)
    b, kvh, h, d = 2048, 8, 32, 128
    lengths = rng.integers(0, 97, b)
    assert tds.plan(b, kvh, 96, q_per_kv=h // kvh,
                    n_sm=tds.sm_count(cuda_device))[0] == 1
    q = torch.from_numpy(rng.normal(size=(b, 1, h, d)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    kp, vp, bt, ln, pos = _paged_pool(rng, lengths, 1, kvh, d, torch.float32,
                                      cuda_device)
    _close_partial(tpfd.paged_flash_decode_partial(q, kp, vp, bt, ln, pos),
                   tpfd.paged_flash_decode_partial_plain(q, kp, vp, bt, ln, pos))
    k = torch.from_numpy(rng.normal(size=(b, 96, kvh, d)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    v = torch.from_numpy(rng.normal(size=(b, 96, kvh, d)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=cuda_device)
    _close_partial(tfd.flash_decode_partial(q, k, v, ln),
                   tfd.flash_decode_partial_plain(q, k, v, ln))


# ------------------------- the unified step's shapes (K2 prefix, K3 chunk)


def _prefix_plane(rng, prefixes, seg_lens, pad, page, kvh, d, dev):
    """Per-token operands of the unified prefix plane on an f32 pool:
    request i (``prefixes[i]`` keys on scattered pages) owns ``seg_lens[i]``
    consecutive packed rows, each carrying the request's whole table row;
    row j of a segment sits at global position prefix + j; ``pad``
    trailing rows hold nothing.  Returns (pages..., table, lengths, pos,
    query positions)."""
    kp, vp, bt, ln, pos = _paged_pool(rng, prefixes, page, kvh, d,
                                      torch.float32, dev)
    owner = torch.as_tensor(np.repeat(np.arange(len(prefixes)), seg_lens),
                            device=dev)
    n = owner.numel()
    table = torch.zeros((n + pad, bt.shape[1]), dtype=torch.int32, device=dev)
    lengths = torch.zeros(n + pad, dtype=torch.int32, device=dev)
    table[:n], lengths[:n] = bt[owner], ln[owner]
    qpos = np.zeros(n + pad, np.int32)
    qpos[:n] = np.concatenate([p + np.arange(s) for p, s in zip(prefixes, seg_lens)])
    return kp, vp, table, lengths, pos, torch.as_tensor(qpos, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 37, 512, 4096])
@pytest.mark.parametrize("page", [1, 16])
def test_unified_prefix_plane_on_card(cuda_device, b, page):
    """K2 at the unified step's shape: one row per packed token (B from 1 to
    4096), many rows sharing a request's table, prefixes of 63 / 64 / 65
    keys around a tile edge, rows with no prefix, padding rows, bf16 q on
    the f32 pool; with and without a window; and every row empty."""
    rng = np.random.default_rng(b + page)
    kvh, h, d = 2, 8, 64
    cycle = [63, 64, 65, 0, 130, 1]
    prefixes, seg_lens, used = [], [], 0
    while used < b:
        n = min(int(rng.integers(1, 200)) if len(prefixes) % 3 == 0 else 1,
                b - used)
        prefixes.append(cycle[len(prefixes) % len(cycle)])
        seg_lens.append(n)
        used += n
    pad = int(seg_lens[-1] > 1)  # a padding tail where the last segment is a chunk
    seg_lens[-1] -= pad
    kp, vp, bt, ln, pos, qpos = _prefix_plane(rng, prefixes, seg_lens, pad,
                                              page, kvh, d, cuda_device)
    q = torch.from_numpy(rng.normal(size=(b, 1, h, d)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    for window in (None, 40):
        kw = dict(query_pos=qpos, window=window)
        _close_partial(tpfd.paged_flash_decode_partial(q, kp, vp, bt, ln, pos, **kw),
                       tpfd.paged_flash_decode_partial_plain(q, kp, vp, bt, ln, pos, **kw))
    empty = torch.zeros_like(ln)
    got = tpfd.paged_flash_decode_partial(q, kp, vp, bt, empty, pos)
    _close_partial(got, tpfd.paged_flash_decode_partial_plain(q, kp, vp, bt, empty, pos))
    assert torch.isinf(got.m).all() and (got.l == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 48])
def test_unified_chunk_plane_on_card(cuda_device, dtype, window):
    """K3 as the unified step's chunk plane (n_shards = 1): three chunks,
    then 40 one-row decode segments (a 64-row q tile spans dozens of
    segments), then a padding tail, folded into a carry taken from K2 whose
    rows with no prefix are empty (m = -inf, l = 0); and the whole layer
    (`core.unified.unified_chunk_attention`, two pool shards) on the card
    against its plain composition on the CPU."""
    from repro_torch.core import unified as tu

    dt = getattr(torch, dtype)
    tc = dt == torch.bfloat16
    rng = np.random.default_rng(41)
    kvh, h, d = 2, 8, 64
    chunks = [(0, 70), (37, 9), (64, 130)]
    decodes = [int(x) for x in rng.integers(0, 140, 40)]
    decodes[::7] = [0] * len(decodes[::7])
    prefixes = [p for p, _ in chunks] + decodes
    seg_lens = [n for _, n in chunks] + [1] * len(decodes)
    pad = 23
    t = sum(seg_lens) + pad
    off = np.full(len(seg_lens) + 5, sum(seg_lens), np.int32)
    off[0] = 0
    off[1:len(seg_lens) + 1] = np.cumsum(seg_lens)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, dt)

    q, k, v = rand(t, h, d), rand(t, kvh, d), rand(t, kvh, d)
    shards = []
    for s in range(2):
        # shard 0 holds each prefix's first half, shard 1 the rest
        part = [x // 2 if s == 0 else x - x // 2 for x in prefixes]
        kp, vp, bt, ln, pos, qpos = _prefix_plane(rng, part, seg_lens, pad, 16,
                                                  kvh, d, cuda_device)
        shards.append((kp, vp, bt, ln, pos))
    p = tpfd.paged_flash_decode_partial(q[:, None], *shards[0][:4])
    carry = (p.o[:, 0], p.m[:, 0], p.l[:, 0])
    assert torch.isinf(carry[1][:chunks[0][1]]).all()  # chunk 0: no prefix
    assert (carry[2] == 0).any() and (carry[2] > 0).any()
    kw = dict(q_shard=0, k_shard=0, n_shards=1, window=window)
    got = tpfp.packed_flash_prefill_ring_chunk(q, k, v, off, off, carry, **kw)
    want = tpfp.packed_flash_prefill_ring_chunk_plain(q, k, v, off, off, carry, **kw)
    if tc:
        _close_partial_tc(got, want, v)
    else:
        for g_, w_ in zip(got, want):
            _close(g_, w_)
    qpos = torch.as_tensor(np.concatenate(
        [pp + np.arange(n) for pp, n in zip(prefixes, seg_lens)] + [np.zeros(pad)]
    ).astype(np.int32), device=cuda_device)
    got = tu.unified_chunk_attention(q, k, v, off, qpos, shards, window=window)
    cpu = lambda x: x.cpu()  # noqa: E731
    want = tu.unified_chunk_attention(
        cpu(q), cpu(k), cpu(v), off, cpu(qpos),
        [tuple(map(cpu, s)) for s in shards], window=window)
    _close_tc(got, want, v) if tc else _close(got, want)
