"""Batched ragged flash-decode over the paged KV pool (K2).

PyTorch counterpart of `repro/kernels/paged_flash_decode.py`, run by the
hand-written CUDA kernel in `csrc/paged_decode.cu` (the split-K decode core
`csrc/decode_splitk.cuh`, planned by `kernels/decode_split.py`).  The
wrapper:

  * on a CPU tensor, returns the plain PyTorch version (block-table gather +
    dense masked partial);
  * on a CUDA tensor, launches the kernel — pass 1 and, when the plan cuts
    the requests' tokens into several splits, the merge; one call counts
    one in `launch_counts` — or raises on what the kernel does not take
    (d % 8 != 0 among them).  Nothing falls back.

Each call reports its work by shape to the op census (`launch.census`),
and what runs to do it runs uncounted.

Contract (mirrors `repro_torch.kvcache.pool.KVPool`):
  * ``q`` [B, 1, H, D]; ``k_pages``/``v_pages`` [n_pages, P, KVH, D] — one
    layer's pool storage, shared by all requests (f32 or bf16; q may be
    either, independently);
  * ``block_table`` [B, max_pages] — request b's local token j lives in page
    ``block_table[b, j // P]`` at offset ``j % P``; ``lengths`` [B] valid
    local tokens (zero-length rows give m=-inf, l=0);
  * window: keys with ``query_pos - page_pos < window`` (``page_pos``
    [n_pages, P] global slot positions, ``query_pos`` [B]).
Returns the unnormalized ``Partial(o [B,1,H,D], m, l [B,1,H])`` in f32;
``max_pages == 0`` gives the empty partial without a launch.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import decode_split, refuse_grad
from repro_torch.launch import census
from repro_torch.models.attention import Partial, empty_partial, partial_attention

#: kernel launches on CUDA tensors (comparisons with the plain version and
#: CPU calls are not launches of the kernel)
launch_counts: Counter = Counter()

def paged_flash_decode_partial_plain(
    q, k_pages, v_pages, block_table, lengths, page_pos=None, *,
    query_pos=None, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Partial:
    """Plain PyTorch K2: gather every request's pages through its block
    table, then one dense masked partial."""
    dev = q.device
    bt = torch.as_tensor(block_table).to(dev).long()
    b, max_pages = bt.shape
    page = k_pages.shape[1]
    if max_pages == 0:
        return empty_partial(b, q.shape[1], q.shape[2], q.shape[3], device=dev)
    s = max_pages * page
    flat = bt.reshape(-1)
    k = k_pages[flat].reshape((b, s) + tuple(k_pages.shape[2:]))
    v = v_pages[flat].reshape((b, s) + tuple(v_pages.shape[2:]))
    j = torch.arange(s, device=dev)
    valid = j[None, :] < torch.as_tensor(lengths).to(dev)[:, None]
    if window is not None:
        kp = torch.as_tensor(page_pos).to(dev)[flat].reshape(b, s)
        valid &= (torch.as_tensor(query_pos).to(dev)[:, None] - kp) < window
    mask = valid[:, None, :].expand(b, q.shape[1], s)
    return partial_attention(q, k, v, mask, softcap=softcap)


def _launch(q, k_pages, v_pages, block_table, lengths, page_pos, *,
            query_pos, window, softcap) -> Partial:
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode kernel: tensors on {q.device}")
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("paged_decode kernel: one query token per request")
    n_pages, page_size, kvh = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if (k_pages.shape[3] != d or v_pages.shape != k_pages.shape or h % kvh
            or h // kvh > 64 or d % 8 or not 8 <= d <= 256):
        raise ValueError(f"paged_decode kernel: shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         "(need h % kvh == 0, h / kvh <= 64, d % 8 == 0, "
                         "8 <= d <= 256)")
    codes = decode_split.DTYPE_CODE
    if (q.dtype not in codes or k_pages.dtype not in codes
            or v_pages.dtype != k_pages.dtype):
        raise TypeError(f"paged_decode kernel: dtypes {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        # the pool's mirror views are contiguous; copying a layer of the
        # pool per launch would hide a layout fault behind a large copy
        raise ValueError("paged_decode kernel: pool pages must be contiguous")
    dev = q.device
    bt = torch.as_tensor(block_table).to(dev, torch.int32).contiguous()
    lens = torch.as_tensor(lengths).to(dev, torch.int32).contiguous()
    if bt.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"paged_decode kernel: block_table {tuple(bt.shape)}, "
                         f"lengths {tuple(lens.shape)} for batch {b}")
    max_pages = bt.shape[1]
    pos = qpos = None
    if window is not None:
        if page_pos is None or query_pos is None:
            raise ValueError("window masking needs page_pos and query_pos")
        pos = torch.as_tensor(page_pos).to(dev, torch.int32).contiguous()
        qpos = torch.as_tensor(query_pos).to(dev, torch.int32).contiguous()
        if pos.numel() != n_pages * page_size or qpos.shape != (b,):
            raise ValueError("paged_decode kernel: page_pos/query_pos shapes")
    return decode_split.launch(
        "paged_decode", (q.contiguous(), k_pages, v_pages, bt, lens, pos, qpos),
        (b, h, kvh, d, page_size, max_pages), q=q, kvh=kvh,
        kv_dtype=k_pages.dtype, n_keys_bound=max_pages * page_size,
        window=window, softcap=softcap,
    )


def paged_flash_decode_partial(
    q, k_pages, v_pages, block_table, lengths, page_pos=None, *,
    query_pos=None, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Partial:
    """K2: one ragged batched launch over the paged pool; returns the
    unnormalized Partial over this instance's KV shard for every request.
    Refuses inputs that require grad (`kernels.refuse_grad`)."""
    refuse_grad("paged_flash_decode_partial", q, k_pages, v_pages)
    b, sq, h, d = q.shape
    if census.active():
        # reads q, the block table's pages of k and v, the int32 table and
        # lengths; writes the f32 (o, m, l)
        nb, mp = block_table.shape[0], block_table.shape[1]
        page_b = k_pages[0].numel() * k_pages.element_size()
        census.report_kernel(
            "K2", census.attention_flops(b, sq, mp * k_pages.shape[1], h, d,
                                         causal=False, window=window),
            census.nbytes(q) + 2 * nb * mp * page_b + 4 * nb * mp + 4 * b
            + 4 * b * sq * h * (d + 2))
    with census.uncounted():
        if q.device.type == "cpu":
            return paged_flash_decode_partial_plain(
                q, k_pages, v_pages, block_table, lengths, page_pos,
                query_pos=query_pos, window=window, softcap=softcap,
            )
        if block_table.shape[1] == 0:
            return empty_partial(b, sq, h, d, device=q.device)
        out = _launch(q, k_pages, v_pages, block_table, lengths, page_pos,
                      query_pos=query_pos, window=window, softcap=softcap)
    launch_counts["paged_flash_decode_partial"] += 1
    return out
