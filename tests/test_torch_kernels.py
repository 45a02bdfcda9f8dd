"""The port's kernels (PyTorch plain versions on the CPU) against the JAX
reference: K1 packed prefill, K3 striped ring step, K2 paged decode.

The same inputs, made from a seed with numpy, go through the reference's
`repro.kernels.ops` — the Pallas kernel body under ``impl="interpret"`` and
the reference math under ``impl="xla"`` — and through the port's wrappers,
which on CPU tensors run their plain versions.  Tolerance 2e-5 atol on
outputs and partials (DESIGN.md §5).  Cases: {MHA, GQA} x {window} x
{softcap}, ragged offsets with empty segments, a 3/4-point bucket T,
zero-length decode rows, page_size {1, 8}, ring n_shards {2, 4} with carry
chaining equal to K1.  The kernels themselves run on the card
(`chip_smoke.py` and tests/test_torch_kernels_gpu.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import esp as tesp  # noqa: E402
from repro_torch.core import striped as tstriped  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_flash_decode as tpfd  # noqa: E402
from repro_torch.kernels import paged_flash_prefill as tpfp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

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
