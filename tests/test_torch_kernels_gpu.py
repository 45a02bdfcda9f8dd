"""The port's CUDA kernels (K1, K3, K2) against their plain PyTorch versions
on a CUDA device.  Marked ``gpu``: they skip where no CUDA device exists.
They import no JAX, so they run on a machine with only PyTorch::

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py

Tolerance 2e-5 atol on normalized outputs and partials at these small
shapes: bf16 operands are widened to f32 in both versions, so the kernel
and the plain version compute the same f32 math in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import striped as tstriped  # noqa: E402
from repro_torch.kernels import paged_flash_decode as tpfd  # noqa: E402
from repro_torch.kernels import paged_flash_prefill as tpfp  # noqa: E402

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
    same inputs (f32 2e-5; bf16 operands are widened to f32 in both, so the
    same tolerance holds)."""
    dt = getattr(torch, dtype)
    q, k, v = (x.to(cuda_device, dt) for x in _t(*_qkv(7, T, H, kvh, D)))
    got = tpfp.packed_flash_prefill(q, k, v, OFFSETS, window=window,
                                    softcap=softcap)
    want = tpfp.packed_flash_prefill_plain(q, k, v, OFFSETS, window=window,
                                           softcap=softcap)
    _close(got, want)
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
