"""The port's CUDA kernels (K1, K3, K2, K4 and its backward, K5) against their plain PyTorch
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
1e-4 absolute, l 1e-4 relative, and empty rows must match.  K4's LSE entry
(the ESP ring step's partial) writes its o in f32 for bf16 operands too, so
it is held without the bf16 output term.  The split-K
decode cases (long rows, many rows) hold o / l and m to 1e-4: f32 sums over
up to 64k keys in another order, merged across splits; so does K5 at
whisper width, and so do K3 and K2 at the serve CLI's width (f32 sums over
up to ~1.8k keys, carried across a ring of up to 8 steps; the normalized
ring output against plain K1 likewise).  The K4 backward
(`csrc/striped_attention_bwd.cu`, fp32 FMAs on either type) against the
plain backward formula on the same inputs (bf16 ones upcast, with the
kernel's own o and LSE): f32 within 2e-4 x max|plain| per tensor, bf16
within 2^-7 x max|plain| (one rounding of the result) with a mean error
within 1e-3 x max|plain|; the forward's LSE within 1e-4 of the plain one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import striped as tstriped  # noqa: E402
from repro_torch.kernels import decode_split as tds  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import paged_flash_decode as tpfd  # noqa: E402
from repro_torch.kernels import paged_flash_prefill as tpfp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
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


def _close_partial(got, want, atol=1e-4):
    """Carried (o, m, l) of f32 operands summed over hundreds of keys: o / l
    within `atol`, m `atol` absolute, l `atol` relative, the same empty
    rows."""
    (o, m, l), (wo, wm, wl) = got, want
    _close(m, wm, atol=atol)
    assert ((l - wl).abs() <= atol * wl.abs()).all()

    def fin_o(o_, l_):
        return o_ / torch.where(l_ == 0, torch.ones_like(l_), l_)[..., None]

    _close(fin_o(o, l), fin_o(wo, wl), atol=atol)


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
@pytest.mark.parametrize("n", [2, 4, 8])
def test_kernels_at_serve_cli_width_on_card(cuda_device, n):
    """K1, K3 and K2 at the shapes ``repro_torch.launch.serve --real`` gives
    them: reduced lwm-7b (f32, H = KVH = 4, D = 32, page size 1), the CLI's
    own sharegpt prompts as one packed batch, K3 through a full ring of `n`
    shards, K2 over the prompts' decode contexts."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import poisson_workload

    cfg = reduced(get_config("lwm-7b"))
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lens = [r.input_len for r in poisson_workload("sharegpt", 8, 0.5, seed=0,
                                                   max_len=256)]
    t = -(-sum(lens) // 64) * 64
    off = np.full(len(lens) + 2, sum(lens), np.int32)
    off[0] = 0
    off[1:len(lens) + 1] = np.cumsum(lens)
    q, k, v = (x.to(cuda_device) for x in _t(*_qkv(n, t, h, kvh, d)))
    k1 = tpfp.packed_flash_prefill_plain(q, k, v, off)
    _close(tpfp.packed_flash_prefill(q, k, v, off), k1)
    offs = [tstriped.shard_offsets(off, n, s) for s in range(n)]
    sched = tstriped.ring_chunk_schedule(n)
    carries = [None] * n
    for step in range(n):
        for r in range(n):
            c = sched[step][r]
            args = (q[r::n], k[c::n], v[c::n], offs[r], offs[c], carries[r])
            kw = dict(q_shard=r, k_shard=c, n_shards=n)
            got = tpfp.packed_flash_prefill_ring_chunk(*args, **kw)
            _close_partial(got, tpfp.packed_flash_prefill_ring_chunk_plain(*args, **kw))
            carries[r] = got
    fin = [o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
           for o, _, l in carries]  # finalized: the normalized ring output
    _close(tstriped.unstripe(torch.cat(fin), n, axis=0), k1, atol=1e-4)
    ctx = np.asarray(lens, np.int32) + 15
    slots = np.random.default_rng(n).permutation(int(ctx.sum()))
    table = np.zeros((len(lens), int(ctx.max())), np.int32)
    starts = np.concatenate([[0], np.cumsum(ctx)])
    for i in range(len(lens)):
        table[i, :ctx[i]] = slots[starts[i]:starts[i + 1]]
    qd, kp, vp = _qkv(n + 1, int(ctx.sum()), h, kvh, d)
    args = [x.to(cuda_device) for x in _t(qd[:len(lens), None], kp[:, None],
                                          vp[:, None], table, ctx)]
    _close_partial(tpfd.paged_flash_decode_partial(*args),
                   tpfd.paged_flash_decode_partial_plain(*args))


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_at_whisper_width_on_card(cuda_device, dtype):
    """K4 and K5 at the shapes whisper-tiny's decoder self-attention gives
    them (H = KVH = 6, D = 64, q_per_kv 1): K4 over a batch of 4 causal
    prompts of 448 and 1500 tokens, K5 over a batch of 4 histories up to 480
    keys, one of them empty."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(16)
    h, d = 6, 64

    def rand(*shape, dtype=dt):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, dtype)

    for s in (448, 1500):
        q, k, v = rand(4, s, h, d), rand(4, s, h, d), rand(4, s, h, d)
        pos = torch.arange(s, dtype=torch.int32, device=cuda_device)
        got = tsa.striped_flash_attention(q, k, v, pos, pos, causal=True)
        want = tsa.striped_flash_attention_plain(q, k, v, pos, pos, causal=True)
        if dt == torch.float32:
            _close(got, want)
        else:
            _close_tc(got, want, v, bf16_out=True)
    q = rand(4, 1, h, d)
    k, v = rand(4, 480, h, d), rand(4, 480, h, d)
    lens = torch.tensor([0, 200, 448, 479], dtype=torch.int32, device=cuda_device)
    got = tfd.flash_decode_partial(q, k, v, lens)
    _close_partial(got, tfd.flash_decode_partial_plain(q, k, v, lens))
    assert torch.isinf(got.m[0]).all() and (got.l[0] == 0).all()


# (tag, B, S, H, KVH, D, ring of n shards (1: contiguous), q shard, KV shard)
K4_LSE_F32_CASES = [("pixtral", 1, 2048, 32, 8, 128, 4, 0, 1),
                    ("pixtral", 1, 2048, 32, 8, 128, 1, 0, 0),
                    ("whisper", 4, 448, 6, 6, 64, 4, 2, 1),
                    ("whisper", 4, 448, 6, 6, 64, 1, 0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K4_LSE_F32_CASES,
                         ids=lambda c: f"{c[0]}-n{c[6]}-q{c[7]}k{c[8]}")
def test_k4_lse_entry_f32_output_on_card(cuda_device, dtype, case):
    """K4's LSE entry (the ESP ring step's partial) writes o in f32 for
    either operand type: at pixtral width (H 32, KVH 8, D 128) and whisper
    width (H = KVH = 6, D 64, B 4), on a ring step of striped shards (q
    shard 0 against KV shard 1 has a row with no key) and on contiguous
    positions.  bf16: o within 1e-4 + 2^-8 max|v| of the plain partial's
    f32 output (no bf16 output rounding), mean below 1e-3; f32 within
    2e-5; the LSE within 1e-4, +inf exactly where a row sees no key."""
    _tag, b, s, h, kvh, d, n, r, c = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(21)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device, dt)

    q, k, v = rand(b, s, h, d), rand(b, s, kvh, d), rand(b, s, kvh, d)
    qp, kp = (torch.as_tensor(np.arange(s) * n + x, dtype=torch.int32, device=cuda_device)
              for x in (r, c))
    before = tsa.launch_counts["striped_flash_attention"]
    o, lse = tsa.striped_flash_attention_lse(q, k, v, qp, kp, causal=True)
    assert tsa.launch_counts["striped_flash_attention"] == before + 1
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    want_o, want_lse = tref.striped_flash_attention_ref_lse(q, k, v, qp, kp, causal=True,
                                                            o_acc=True)
    assert want_o.dtype == torch.float32
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin) and (lse[~fin] > 0).all()
    if (r, c) == (0, 1):
        assert not fin.all()  # the first query precedes every key
    assert (lse[fin] - want_lse[fin]).abs().max().item() <= 1e-4
    if dt == torch.bfloat16:
        _close_tc(o, want_o, v)
    else:
        _close(o, want_o, atol=ATOL)


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


# ---------------------------------------------------- K4 under a gradient

def _close_bwd(got, want, bf16):
    """The K4 backward against the plain one, per tensor: f32 within 2e-4 x
    max|plain| (f32 sums over the keys or queries in another order); a bf16
    result is the f32 one rounded once (2^-7 x max|plain|) and its mean
    error stays within 1e-3 x max|plain|."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs()
    assert not torch.isnan(got).any()
    if bf16:
        assert err.max().item() <= 2.0 ** -7 * scale, (err.max().item(), scale)
        assert err.mean().item() <= 1e-3 * scale, (err.mean().item(), scale)
    else:
        assert err.max().item() <= 2e-4 * scale, (err.max().item(), scale)


# (B, Sq, Sk, H, KVH, D, causal, window, softcap, positions)
K4_BWD_CASES = [
    (2, 77, 77, 4, 2, 32, True, None, None, "contiguous"),
    (1, 130, 130, 32, 2, 128, True, None, None, "contiguous"),  # GQA 16
    (2, 100, 100, 8, 8, 80, True, 40, None, "contiguous"),
    (2, 45, 70, 4, 4, 64, False, None, 5.0, "contiguous"),
    (1, 64, 64, 4, 1, 256, True, 30, 20.0, "striped"),
    (2, 50, 61, 4, 2, 16, True, 20, None, "unsorted"),
    (1, 40, 40, 2, 2, 32, True, None, None, "empty rows"),
    # the bf16 route's tile edges: 64-row q tiles of (token, q head) rows,
    # 128-key dk / dv CTAs (64 at D 256, two column halves), 64-key tiles
    (2, 200, 333, 8, 8, 128, True, None, None, "contiguous"),  # q_per_kv 1
    (1, 150, 211, 16, 4, 128, True, 120, None, "contiguous"),  # q_per_kv 4
    (1, 70, 190, 16, 1, 128, False, None, None, "contiguous"),  # q_per_kv 16
    (1, 100, 100, 24, 2, 80, True, 37, 30.0, "contiguous"),  # 12: heads straddle tiles
    (2, 130, 150, 4, 2, 256, True, 50, 20.0, "contiguous"),
    (1, 300, 300, 8, 2, 128, True, 100, None, "striped"),
    (2, 150, 200, 6, 2, 64, True, 90, None, "unsorted"),  # 3: heads straddle tiles
]


def _k4_bwd_inputs(case, dt, dev, seed=0):
    b, sq, sk, h, kvh, d, causal, window, softcap, kind = case
    rng = np.random.default_rng(seed)
    if kind == "striped":
        qp, kp = np.arange(sq) * 4 + 3, np.arange(sk) * 4 + 1
    elif kind == "unsorted":
        n = max(80, sq, sk)
        qp, kp = rng.permutation(n)[:sq], rng.permutation(n)[:sk]
    elif kind == "empty rows":
        qp, kp = np.arange(sq), np.arange(sk) + 9
    else:
        qp, kp = np.arange(sq) + (sk - sq), np.arange(sk)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dt)

    q, k, v, do = rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d), \
        rand(b, sq, h, d)
    pos = [torch.as_tensor(x, dtype=torch.int32, device=dev) for x in (qp, kp)]
    return q, k, v, do, pos, dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K4_BWD_CASES, ids=lambda c: f"{c[9]}-d{c[5]}-h{c[3]}/{c[4]}")
def test_k4_backward_matches_plain_on_card(cuda_device, dtype, case):
    """The forward's LSE (both routes) against the plain LSE, and the
    backward kernel against the plain backward formula on the same inputs
    (the f32 upcast of bf16 ones, with the kernel's o and lse)."""
    dt = getattr(torch, dtype)
    q, k, v, do, (qp, kp), kw = _k4_bwd_inputs(case, dt, cuda_device)
    o, lse = tsa._launch(q, k, v, qp, kp, lse=True, **kw)
    want_o, want_lse = tref.striped_flash_attention_ref_lse(
        q.float(), k.float(), v.float(), qp, kp, **kw)
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin) and (lse[~fin] > 0).all()
    assert (lse[fin] - want_lse[fin]).abs().max().item() <= 1e-4
    got = tsa._launch_bwd(q, k, v, o, do, lse, qp, kp, **kw)
    want = tref.striped_flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                                o.float(), do.float(), lse, qp,
                                                kp, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dt
        _close_bwd(g, w, dt == torch.bfloat16)
    if case[9] == "empty rows":  # queries before every key: exact zeros
        assert (got[0][:, :9] == 0).all() and (o[:, :9] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", K4_BWD_CASES, ids=lambda c: f"{c[9]}-d{c[5]}-h{c[3]}/{c[4]}")
def test_k4_backward_is_deterministic_on_card(cuda_device, case):
    """The backward has no atomics: two calls on the same bf16 inputs give
    bitwise-equal (dq, dk, dv)."""
    q, k, v, do, (qp, kp), kw = _k4_bwd_inputs(case, torch.bfloat16, cuda_device, 2)
    o, lse = tsa._launch(q, k, v, qp, kp, lse=True, **kw)
    first = tsa._launch_bwd(q, k, v, o, do, lse, qp, kp, **kw)
    second = tsa._launch_bwd(q, k, v, o, do, lse, qp, kp, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", K4_BWD_CASES[:4], ids=lambda c: f"d{c[5]}-h{c[3]}/{c[4]}")
def test_k4_function_grads_match_autograd_on_card(cuda_device, case):
    """On CUDA tensors under grad, K4's output has the `Function`'s
    grad_fn, its backward launches the kernel once, and its gradients equal
    plain autograd through the plain version (f32)."""
    q, k, v, do, (qp, kp), kw = _k4_bwd_inputs(case, torch.float32, cuda_device, 1)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before = tsa.launch_counts["striped_flash_attention_bwd"]
    out = tsa.striped_flash_attention(q, k, v, qp, kp, **kw)
    assert type(out.grad_fn).__name__ == "StripedFlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), do.transpose(1, 2).contiguous()
                              .transpose(1, 2))  # a strided gradient
    assert tsa.launch_counts["striped_flash_attention_bwd"] == before + 1
    ref_out = tsa.striped_flash_attention_plain(q, k, v, qp, kp, **kw)
    want = torch.autograd.grad(ref_out, (q, k, v), do)
    for g, w in zip(got, want):
        _close_bwd(g, w, False)


@pytest.mark.gpu
def test_serving_kernels_refuse_grad_on_card(cuda_device):
    q, k, v = (torch.randn(16, 2, 16, device=cuda_device) for _ in range(3))
    off = torch.tensor([0, 16], dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        tpfp.packed_flash_prefill(q.requires_grad_(True), k, v, off)
    qd = torch.randn(2, 1, 2, 16, device=cuda_device, requires_grad=True)
    kd = torch.randn(2, 8, 2, 16, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        tfd.flash_decode_partial(qd, kd, kd, torch.tensor([3, 8], device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_census_work_on_card_equals_meta(cuda_device, dtype):
    """Each kernel reports its work to the op census (`launch.census`) by
    shape: a launch on the card counts what the same call on meta tensors
    counts (K4 forward, its LSE entry and backward, K5), and the launch's
    own preparation is not counted."""
    from repro_torch.kernels import ops
    from repro_torch.launch.census import Census

    dt = getattr(torch, dtype)
    b, sq, sk, h, kvh, d = 2, 96, 160, 4, 2, 32

    def run(dev):
        g = torch.Generator().manual_seed(3)

        def mk(*s):
            x = torch.randn(*s, generator=g).to(dt)
            return x.to(dev) if dev == "cuda" else x.new_empty(x.shape, device=dev)

        q, k, v = mk(b, sq, h, d), mk(b, sk, kvh, d), mk(b, sk, kvh, d)
        qp = torch.arange(sk - sq, sk, device=dev)
        kp = torch.arange(sk, device=dev)
        qd = mk(b, 1, h, d)
        lens = torch.tensor([sk, 17], device=dev)
        out = {}
        with Census() as c:
            tsa.striped_flash_attention(q, k, v, qp, kp, causal=True, window=64)
        out["K4"] = c.result()
        with Census() as c:
            ops.attention_partial(q, k, v, qp, kp, causal=True)
        out["K4 lse"] = c.result()
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        with Census() as c:
            o = tsa.striped_flash_attention(q, k, v, qp, kp, causal=True)
            torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        out["K4 bwd"] = c.result()
        with Census() as c, torch.no_grad():
            ops.decode_partial(qd, k.detach(), v.detach(), lens, window=100)
        out["K5"] = c.result()
        return out

    launched = dict(tsa.launch_counts)
    got = run("cuda")
    assert tsa.launch_counts["striped_flash_attention_bwd"] > launched.get(
        "striped_flash_attention_bwd", 0)
    assert got == run("meta")
    assert got["K4"]["kernels"]["K4"]["calls"] == 1
    assert got["K4"]["flops"] == got["K4"]["kernels"]["K4"]["flops"]
    assert set(got["K4 bwd"]["kernels"]) == {"K4", "K4 bwd"}
